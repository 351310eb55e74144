// Tile compositing, forward.
//
// Replaces the Pallas kernel `_fwd_kernel` launched by `rasterize_fwd_impl`
// (rodygs_tpu/render/tile_kernel.py). Each 16x16 tile composites its
// depth-sorted fragment range [start, start + count) front to back:
// alpha = min(0.99, o * exp(-sigma)); fragments with sigma < 0 or
// alpha < 1/255 are skipped; a pixel stops at the first fragment that would
// take its transmittance below 1e-4. Output: 8 channel planes per tile
// (rgb, depth, normal, alpha = feature row 13, which is 1), pixel
// p = py * 16 + px whatever the thread-to-pixel map.
//
// The stop decision is the TPU kernel's: log T += log1p(-alpha) with
// explicitly rounded operations, compared against log(1e-4) (common.cuh).
// The weight alpha * T takes T from a running product beside that carry
// (T -= alpha * T), which the decision does not depend on; it spares an expf
// per contributing pair.
//
// Bound on the H100: instructions executed per (warp, fragment), not bytes (the
// records are read once per tile) and not the FP32 arithmetic itself. Three
// in four (pixel, fragment) pairs that a 16x2 strip evaluates are rejected,
// yet a warp pays the contributing path (log1pf, the accumulation) when any
// lane contributes. What the design does about it (tile_common.cuh):
//  - a warp is an 8x4 pixel block, so fewer fragments touch it at all, and a
//    ballot over a conservative rectangle test lets it walk only those;
//  - a record is staged packed, read back with two broadcast 128-bit shared
//    loads for the geometry and one (two with live normals) for the features,
//    the latter only by lanes that contribute, where the first design ran
//    14 scalar loads;
//  - batch b + 1 is copied with cp.async while batch b is walked, one
//    __syncthreads per batch, which also carries the block's early-exit vote;
//  - NORMALS = false (the trainer's renders, whose normal rows are zero and
//    whose alpha feature is 1) stages 10 rows, not 14, and accumulates
//    r, g, b, depth and alpha += w: five FMAs in place of eight;
//  - the walk takes the kept fragments two at a time (ILP): their alphas and
//    log1p terms do not depend on the carried transmittance, so two of the
//    long dependent chains (expf, log1pf) are in flight per warp and only
//    the carry itself is serial.
// A warp whose 32 pixels are all stopped leaves the walk. What is left is
// bound by the instruction count: some 100 per walked (warp, fragment), a
// third of them log1pf and a tenth expf, both kept at full precision because
// the stop decision must fall on the plain version's values.
#include "tile_common.cuh"

using namespace rodygs;

namespace {
constexpr int BATCH = 64;   // fragments per staged batch: two ballot rounds
}

template <bool NORMALS>
__global__ void __launch_bounds__(PIX, MIN_BLOCKS)
tile_fwd_kernel(const float* __restrict__ records, int P,
                const int* __restrict__ starts, const int* __restrict__ counts,
                const int* __restrict__ offset, int tiles_x,
                float* __restrict__ out) {
  constexpr int NVEC = NORMALS ? 4 : 3;
  constexpr int NROWS = NORMALS ? 14 : 10;
  __shared__ float4 s_rec[2][NVEC * BATCH];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const PixelMap pm = pixel_map(tid);
  const int tile_id = offset[0] + t;
  const int tile_x0 = (tile_id % tiles_x) * TILE;
  const int tile_y0 = (tile_id / tiles_x) * TILE;
  const float px = (float)(tile_x0 + pm.lx);
  const float py = (float)(tile_y0 + pm.ly);
  const float rx0 = (float)(tile_x0 + pm.rx0), ry0 = (float)(tile_y0 + pm.ry0);
  const float rx1 = rx0 + (float)(pm.rw - 1), ry1 = ry0 + (float)(pm.rh - 1);
  const int start = starts[t];
  const int count = counts[t];
  const int num_batches = (count + BATCH - 1) / BATCH;

  float log_t = 0.f;
  float T = 1.f;
  bool done = false;
  float acc[NUM_CHANNELS];
#pragma unroll
  for (int c = 0; c < NUM_CHANNELS; ++c) acc[c] = 0.f;

  if (num_batches > 0)
    stage_batch<NROWS, BATCH>(records, P, start, min(BATCH, count), s_rec[0], tid);
  for (int b = 0; b < num_batches; ++b) {
    cp_async_wait_all();
    // batch b has landed for every thread, and nobody still reads the
    // stage that batch b + 1 goes into
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(BATCH, count - b * BATCH);
    if (b + 1 < num_batches)
      stage_batch<NROWS, BATCH>(records, P, start + (b + 1) * BATCH,
                                min(BATCH, count - (b + 1) * BATCH),
                                s_rec[(b + 1) & 1], tid);
    const float4* stage = s_rec[b & 1];
#pragma unroll
    for (int sub = 0; sub < BATCH / 32; ++sub) {
      if (sub * 32 >= n || __all_sync(FULL, done)) break;
      unsigned m = warp_keep_mask<BATCH>(stage, sub, n, lane, rx0, ry0, rx1, ry1);
      while (m) {
        // the next ILP kept fragments, evaluated side by side: their alphas
        // and log1p terms do not depend on the carried transmittance, so
        // the long dependent chains overlap; only the carry is serial
        int q[ILP];
        bool pass[ILP];
        float alpha[ILP];
        bool any_pass = false;
#pragma unroll
        for (int u = 0; u < ILP; ++u) {
          const bool valid = m != 0u;        // uniform over the warp
          q[u] = valid ? sub * 32 + __ffs(m) - 1 : q[0];
          m &= m - 1;
          const float4 v0 = stage[q[u]];
          const float4 v1 = stage[BATCH + q[u]];
          const float dx = px - v0.x;
          const float dy = py - v0.y;
          const float sigma = conic_sigma(v0.z, v0.w, v1.x, dx, dy);
          alpha[u] = fminf(ALPHA_MAX, unclamped_alpha(v1.y, sigma));
          pass[u] = valid && !done && sigma >= 0.f && alpha[u] >= ALPHA_EPS;
          any_pass |= pass[u];
        }
        if (!any_pass) continue;
        float log1m[ILP];
#pragma unroll
        for (int u = 0; u < ILP; ++u) log1m[u] = log1pf(-alpha[u]);
#pragma unroll
        for (int u = 0; u < ILP; ++u) {
          if (!pass[u] || done) continue;
          const float log_t_incl = __fadd_rn(log_t, log1m[u]);  // log_t_step()
          if (!(log_t_incl >= LOG_T_EPS)) { done = true; continue; }
          const float w = alpha[u] * T;
          const float4 f0 = stage[2 * BATCH + q[u]];
          acc[0] += w * f0.x;
          acc[1] += w * f0.y;
          acc[2] += w * f0.z;
          acc[3] += w * f0.w;
          if (NORMALS) {
            const float4 f1 = stage[3 * BATCH + q[u]];
            acc[4] += w * f1.x;
            acc[5] += w * f1.y;
            acc[6] += w * f1.z;
            acc[7] += w * f1.w;
          } else {
            acc[7] += w;
          }
          T -= w;
          log_t = log_t_incl;
        }
      }
    }
  }
  cp_async_wait_all();
  float* o = out + (size_t)t * NUM_CHANNELS * PIX + pm.ly * TILE + pm.lx;
#pragma unroll
  for (int c = 0; c < NUM_CHANNELS; ++c) o[c * PIX] = acc[c];
}

extern "C" int rodygs_tile_fwd(const float* records, int P, const int* starts,
                               const int* counts, const int* offset,
                               int num_tiles, int tiles_x, int normals,
                               float* out, cudaStream_t stream) {
  if (num_tiles > 0) {
    if (normals)
      tile_fwd_kernel<true><<<num_tiles, PIX, 0, stream>>>(
          records, P, starts, counts, offset, tiles_x, out);
    else
      tile_fwd_kernel<false><<<num_tiles, PIX, 0, stream>>>(
          records, P, starts, counts, offset, tiles_x, out);
  }
  return (int)cudaGetLastError();
}

// Blocks of this kernel that one SM holds at once, by the runtime's own
// count (registers, shared memory, threads); < 0 on error.
extern "C" int rodygs_tile_fwd_blocks_per_sm(int normals) {
  int blocks = 0;
  const cudaError_t err =
      normals ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, tile_fwd_kernel<true>, PIX, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &blocks, tile_fwd_kernel<false>, PIX, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}
