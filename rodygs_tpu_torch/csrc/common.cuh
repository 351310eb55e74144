// Shared constants of the rasterizer kernels. They mirror the Python side
// (render/compact.py, render/tile_kernel.py); a change here needs the same
// change there.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace rodygs {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;        // pixels per tile = threads per block
constexpr int NUM_CHANNELS = 8;         // r, g, b, depth, nx, ny, nz, alpha
constexpr int NUM_FIELDS = 16;          // record rows of the [16, P] layout
constexpr int FEAT0 = 6;                // feature rows [6, 14)
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float LOG_T_EPS = -9.210340371976184f;   // log(1e-4)

// expand / segsum: the packed table of compact.build_table
constexpr int FCHUNK = 512;             // fragments per chunk (bases[] entry)
constexpr int WIN = FCHUNK + 128;       // gaussian window per chunk
constexpr int NUM_REC_ROWS = 13;
constexpr int ROW_BASE_TILE = 13;
constexpr int ROW_DBITS = 14;
constexpr int ROW_OFF = 15;
constexpr int ROW_SPANW = 16;
constexpr int ROW_SPAN_MAX = 8;
constexpr int ROW_RMODE = 17;
constexpr int ROW_ROWOFF0 = 18;
constexpr int ROW_TXLO0 = 18 + ROW_SPAN_MAX;

// The arithmetic that decides whether a pixel takes a fragment, skips it or
// stops: the conic form sigma = 0.5 (a dx^2 + c dy^2) + b dx dy, the
// unclamped alpha o * exp(-sigma) and the log-transmittance step. It is
// written with explicitly rounded operations (__fmul_rn / __fadd_rn), which
// nvcc never contracts into FMAs, so it takes the plain PyTorch version's
// IEEE operations in its order and both take the same decisions. The rest
// of each kernel (weights, accumulations, gradients) is left to FMA.
__device__ __forceinline__ float conic_sigma(float ca, float cb, float cc,
                                             float dx, float dy) {
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                               __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fadd_rn(__fmul_rn(0.5f, quad), __fmul_rn(__fmul_rn(cb, dx), dy));
}

__device__ __forceinline__ float unclamped_alpha(float op, float sigma) {
  return __fmul_rn(op, expf(-sigma));
}

__device__ __forceinline__ float log_t_step(float log_t, float alpha) {
  return __fadd_rn(log_t, log1pf(-alpha));
}

}  // namespace rodygs
