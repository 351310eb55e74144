// Tile compositing, backward (analytic, by recompute).
//
// Replaces the Pallas kernel `_bwd_kernel` launched by `rasterize_bwd_impl`
// (rodygs_tpu/render/tile_kernel.py). From the forward output O and its
// cotangent g (both [T, 8, 256]) it rebuilds each pixel's front-to-back
// traversal and emits, per fragment, d(mx, my, ca, cb, cc, op) and d(8
// features), summed over the tile's 256 pixels, into d_records [16, P].
// The suffix term sum_{j>i} w_j f_j.g is g.O minus the inclusive prefix of
// w f.g, as in the TPU kernel; the 0.99 alpha clamp has a zero subgradient.
//
// Bound on the H100: arithmetic on the (pixel, fragment) pairs plus the
// per-fragment reduction of 14 values over 256 pixels. Design: one block
// per tile, one thread per pixel, 64 records staged per batch in shared
// memory. Each warp reduces a fragment's 14 values with shuffles (skipped
// when no lane of the warp touches the fragment); lane 0 parks the warp
// sum in shared memory and the block adds the 8 warp sums and writes the
// row once. A fragment lies in exactly one tile's range, so every output
// column has a single writer: no atomics, and the result does not depend
// on scheduling. The TPU kernel needed a read-modify-write of its output
// only because its 128-lane chunks overlap neighbouring tiles' ranges.
// The caller zeroes d_records first; columns outside every tile range (and
// fragments after a tile's early exit) keep 0.
#include "common.cuh"

using namespace rodygs;

namespace {
constexpr int BATCH = 64;
constexpr int NREC = 14;       // mx, my, ca, cb, cc, op + 8 features
constexpr int NGRAD = 14;      // d of the same 14 rows
constexpr int NWARP = PIX / 32;
}

__global__ void __launch_bounds__(PIX)
tile_bwd_kernel(const float* __restrict__ records, int P,
                const int* __restrict__ starts, const int* __restrict__ counts,
                const int* __restrict__ offset, int tiles_x,
                const float* __restrict__ out, const float* __restrict__ gout,
                float* __restrict__ d_records) {
  __shared__ float s_rec[NREC][BATCH];
  __shared__ float s_grad[NWARP][BATCH][NGRAD];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile_id = offset[0] + t;
  const float px = (float)((tile_id % tiles_x) * TILE + (tid % TILE));
  const float py = (float)((tile_id / tiles_x) * TILE + (tid / TILE));
  const int start = starts[t];
  const int count = counts[t];

  float gpix[NUM_CHANNELS];
  float g_o = 0.f;
  const size_t pbase = (size_t)t * NUM_CHANNELS * PIX + tid;
#pragma unroll
  for (int c = 0; c < NUM_CHANNELS; ++c) {
    gpix[c] = gout[pbase + c * PIX];
    g_o += gpix[c] * out[pbase + c * PIX];
  }

  float log_t = 0.f;
  float prefu = 0.f;
  bool done = false;

  for (int b0 = 0; b0 < count; b0 += BATCH) {
    const int n = min(BATCH, count - b0);
    __syncthreads();
    if (tid < n) {
      const int j = start + b0 + tid;
#pragma unroll
      for (int r = 0; r < NREC; ++r) s_rec[r][tid] = records[(size_t)r * P + j];
    }
    __syncthreads();
    for (int q = 0; q < n; ++q) {
      float v[NGRAD];
#pragma unroll
      for (int r = 0; r < NGRAD; ++r) v[r] = 0.f;
      bool active = false;
      if (!done) {
        const float dx = px - s_rec[0][q];
        const float dy = py - s_rec[1][q];
        const float ca = s_rec[2][q], cb = s_rec[3][q], cc = s_rec[4][q];
        const float sigma = conic_sigma(ca, cb, cc, dx, dy);
        const float G = expf(-sigma);
        const float unclamped = unclamped_alpha(s_rec[5][q], sigma);
        const float alpha = fminf(ALPHA_MAX, unclamped);
        if (sigma >= 0.f && alpha >= ALPHA_EPS) {
          const float log_t_incl = log_t_step(log_t, alpha);
          if (!(log_t_incl >= LOG_T_EPS)) {
            done = true;
          } else {
            active = true;
            const float T = expf(log_t);
            const float w = alpha * T;
            float fg = 0.f;
#pragma unroll
            for (int c = 0; c < NUM_CHANNELS; ++c) fg += gpix[c] * s_rec[FEAT0 + c][q];
            prefu += w * fg;
            const float suffix = g_o - prefu;
            const float d_alpha = T * fg - suffix / (1.f - alpha);
            const float d_unc = unclamped < ALPHA_MAX ? d_alpha : 0.f;
            const float d_sigma = -unclamped * d_unc;
            v[0] = d_sigma * -(ca * dx + cb * dy);
            v[1] = d_sigma * -(cc * dy + cb * dx);
            v[2] = d_sigma * 0.5f * dx * dx;
            v[3] = d_sigma * dx * dy;
            v[4] = d_sigma * 0.5f * dy * dy;
            v[5] = G * d_unc;
#pragma unroll
            for (int c = 0; c < NUM_CHANNELS; ++c) v[6 + c] = w * gpix[c];
            log_t = log_t_incl;
          }
        }
      }
      if (__any_sync(0xffffffffu, active)) {
#pragma unroll
        for (int r = 0; r < NGRAD; ++r) {
          float x = v[r];
#pragma unroll
          for (int s = 16; s > 0; s >>= 1) x += __shfl_down_sync(0xffffffffu, x, s);
          v[r] = x;
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < NGRAD; ++r) s_grad[warp][q][r] = v[r];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < NGRAD * n; idx += PIX) {
      const int r = idx / n;
      const int q = idx - r * n;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) s += s_grad[w][q][r];
      d_records[(size_t)r * P + start + b0 + q] = s;
    }
    if (__syncthreads_count(!done) == 0) break;
  }
}

extern "C" int rodygs_tile_bwd(const float* records, int P, const int* starts,
                               const int* counts, const int* offset,
                               int num_tiles, int tiles_x, const float* out,
                               const float* gout, float* d_records,
                               cudaStream_t stream) {
  if (num_tiles > 0)
    tile_bwd_kernel<<<num_tiles, PIX, 0, stream>>>(records, P, starts, counts,
                                                   offset, tiles_x, out, gout,
                                                   d_records);
  return (int)cudaGetLastError();
}
