// Tile compositing, forward.
//
// Replaces the Pallas kernel `_fwd_kernel` launched by `rasterize_fwd_impl`
// (rodygs_tpu/render/tile_kernel.py). Each 16x16 tile composites its
// depth-sorted fragment range [start, start + count) front to back:
// alpha = min(0.99, o * exp(-sigma)); fragments with sigma < 0 or
// alpha < 1/255 are skipped; a pixel stops at the first fragment that would
// take its transmittance below 1e-4. Output: 8 channel planes per tile
// (rgb, depth, normal, alpha = feature row 13, which is 1).
//
// Transmittance is carried in log space, log T += log1p(-alpha), exactly as
// the TPU kernel does (it takes T = exp(sum log1p(-alpha))), so the stop
// decision compares the same quantity against log(1e-4); the weight is
// alpha * exp(log T) of the transmittance before the fragment.
//
// Bound on the H100: arithmetic on the (pixel, fragment) pairs (two
// transcendentals and ~30 FP32 operations each); the records are read once
// per tile. Design: one block per tile, one thread per pixel; the block
// stages 256 records at a time in shared memory (coalesced field-major row
// reads) and every thread walks them in order. The TPU kernel's 128-wide
// triangular-matmul prefix sums and double-buffered DMAs have no place
// here: a thread walks its pixel's fragments sequentially. The block exits
// early once no pixel is still accumulating (__syncthreads_count), the
// counterpart of the TPU kernel's max(log_t) loop condition.
#include "common.cuh"

using namespace rodygs;

namespace {
constexpr int BATCH = PIX;
constexpr int NREC = 14;   // mx, my, ca, cb, cc, op + 8 features
}

__global__ void __launch_bounds__(PIX)
tile_fwd_kernel(const float* __restrict__ records, int P,
                const int* __restrict__ starts, const int* __restrict__ counts,
                const int* __restrict__ offset, int tiles_x,
                float* __restrict__ out) {
  __shared__ float s_rec[NREC][BATCH];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int tile_id = offset[0] + t;
  const float px = (float)((tile_id % tiles_x) * TILE + (tid % TILE));
  const float py = (float)((tile_id / tiles_x) * TILE + (tid / TILE));
  const int start = starts[t];
  const int count = counts[t];

  float log_t = 0.f;
  bool done = false;
  float acc[NUM_CHANNELS];
#pragma unroll
  for (int c = 0; c < NUM_CHANNELS; ++c) acc[c] = 0.f;

  for (int b0 = 0; b0 < count; b0 += BATCH) {
    const int n = min(BATCH, count - b0);
    __syncthreads();
    if (tid < n) {
      const int j = start + b0 + tid;
#pragma unroll
      for (int r = 0; r < NREC; ++r) s_rec[r][tid] = records[(size_t)r * P + j];
    }
    __syncthreads();
    if (!done) {
      for (int q = 0; q < n; ++q) {
        const float dx = px - s_rec[0][q];
        const float dy = py - s_rec[1][q];
        const float sigma = conic_sigma(s_rec[2][q], s_rec[3][q], s_rec[4][q],
                                        dx, dy);
        const float alpha = fminf(ALPHA_MAX, unclamped_alpha(s_rec[5][q], sigma));
        if (!(sigma >= 0.f) || !(alpha >= ALPHA_EPS)) continue;
        const float log_t_incl = log_t_step(log_t, alpha);
        if (!(log_t_incl >= LOG_T_EPS)) { done = true; break; }
        const float w = alpha * expf(log_t);
#pragma unroll
        for (int c = 0; c < NUM_CHANNELS; ++c) acc[c] += w * s_rec[FEAT0 + c][q];
        log_t = log_t_incl;
      }
    }
    if (__syncthreads_count(!done) == 0) break;
  }
  float* o = out + (size_t)t * NUM_CHANNELS * PIX;
#pragma unroll
  for (int c = 0; c < NUM_CHANNELS; ++c) o[c * PIX + tid] = acc[c];
}

extern "C" int rodygs_tile_fwd(const float* records, int P, const int* starts,
                               const int* counts, const int* offset,
                               int num_tiles, int tiles_x, float* out,
                               cudaStream_t stream) {
  if (num_tiles > 0)
    tile_fwd_kernel<<<num_tiles, PIX, 0, stream>>>(records, P, starts, counts,
                                                   offset, tiles_x, out);
  return (int)cudaGetLastError();
}
