// What the two tile compositors (tile_fwd.cu, tile_bwd.cu) share: the
// thread-to-pixel map, the packed record staging with asynchronous copies,
// and the conservative whole-warp cull.
//
// A block is one 16x16 tile, a thread one pixel, a warp an 8x4 pixel block
// (two across, four down). A fragment's record is staged in shared memory as
// float4 vectors so that a warp reads it with broadcast 128-bit loads:
//   v0 = (mx, my, conic a, conic b)    v1 = (conic c, opacity, -, -)
//   v2 = (r, g, b, depth)              v3 = (nx, ny, nz, alpha feature)
// v3 is staged only when the normal rows are live. The rows of the [16, P]
// layout are contiguous but a tile's start is unaligned, so the copies are
// 4-byte cp.async (TMA's bulk copy needs 16-byte alignment); batch b + 1 is
// in flight in the other half of a two-stage ring while batch b is walked.
//
// The cull: before a warp walks 32 staged fragments, lane l tests fragment l
// against the warp's pixel rectangle and a ballot gives the warp a bit mask;
// the walk visits set bits only, so a fragment that no pixel of the warp can
// take costs the warp no instruction at all. The test bounds the conic form
// from below over the rectangle (it is convex: its minimum lies at the centre
// if that is inside, else on one of the four edges) and compares with
// ln(255 * opacity), the largest sigma at which alpha reaches 1/255. It may
// only keep a pair that a pixel would reject, never drop one that a pixel
// would take: the margin CULL_ABS + CULL_REL * (largest magnitude the form's
// terms reach on the rectangle) is orders above the rounding of either side,
// and any comparison that fails on a NaN or a non-convex form keeps the pair.
// render/tile_kernel.py::warp_cull_keep_plain is the same formula in
// PyTorch, tested on the CPU for being conservative.
#pragma once
#include "common.cuh"

namespace rodygs {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NWARP = PIX / 32;
constexpr int MIN_BLOCKS = 4;   // blocks per SM that __launch_bounds__ asks for
constexpr int ILP = 2;          // fragments a warp evaluates side by side
constexpr float CULL_ABS = 1e-2f;
constexpr float CULL_REL = 1e-5f;
constexpr float CULL_MIN_DET = 1e-5f;   // det > this * a * c, else no bound

// Local pixel (lx, ly) of a thread, and its warp's rectangle in the tile.
struct PixelMap {
  int lx, ly;        // pixel inside the tile
  int rx0, ry0;      // first pixel of the warp's rectangle
  int rw, rh;        // rectangle extent
};

__device__ __forceinline__ PixelMap pixel_map(int tid) {
  PixelMap m;
  const int lane = tid & 31, warp = tid >> 5;
  m.rx0 = (warp & 1) * 8; m.ry0 = (warp >> 1) * 4; m.rw = 8; m.rh = 4;
  m.lx = m.rx0 + (lane & 7); m.ly = m.ry0 + (lane >> 3);
  return m;
}

// ---- staging --------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy rows [0, NROWS) of fragments [j0, j0 + n) into one stage, packed as
// NVEC float4 per fragment: stage[v * BATCH + q]. Neighbouring threads take
// neighbouring fragments of one row, so the global reads coalesce.
template <int NROWS, int BATCH>
__device__ __forceinline__ void stage_batch(const float* __restrict__ records,
                                            int P, int j0, int n,
                                            float4* stage, int tid) {
#pragma unroll
  for (int e0 = 0; e0 < NROWS * BATCH; e0 += PIX) {
    const int e = e0 + tid;
    const int r = e / BATCH;          // BATCH is a power of two: a shift
    const int q = e % BATCH;
    if (r < NROWS && q < n) {
      const int slot = r < FEAT0 ? r : r + 2;   // v1 keeps two spare words
      float* dst = reinterpret_cast<float*>(stage + (slot >> 2) * BATCH + q)
                   + (slot & 3);
      cp_async4(dst, records + (size_t)r * P + j0 + q);
    }
  }
  cp_async_commit();
}

// ---- the whole-warp cull ---------------------------------------------------

// The form at (dx, dy), any rounding: only compared through the margin.
__device__ __forceinline__ float form_at(float ca, float cb, float cc,
                                         float dx, float dy) {
  return 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
}

// False only if no pixel centre in [x0, x1] x [y0, y1] can have sigma >= 0
// and opacity * exp(-sigma) >= 1/255.
__device__ __forceinline__ bool rect_may_take(float4 v0, float4 v1, float x0,
                                              float y0, float x1, float y1) {
  const float mx = v0.x, my = v0.y, ca = v0.z, cb = v0.w;
  const float cc = v1.x, op = v1.y;
  if (op < ALPHA_EPS) return false;        // alpha <= opacity where sigma >= 0
  if (!(ca > 0.f && cc > 0.f && ca * cc - cb * cb > CULL_MIN_DET * ca * cc))
    return true;
  const float dx0 = x0 - mx, dx1 = x1 - mx, dy0 = y0 - my, dy1 = y1 - my;
  if (dx0 <= 0.f && dx1 >= 0.f && dy0 <= 0.f && dy1 >= 0.f) return true;
  // edge minimiser per unit offset; an error in it moves the value at the
  // minimum in second order only, far inside the margin
  const float ty0 = __fdividef(-cb, cc), tx0 = __fdividef(-cb, ca);
  float smin = form_at(ca, cb, cc, dx0, fminf(fmaxf(ty0 * dx0, dy0), dy1));
  smin = fminf(smin, form_at(ca, cb, cc, dx1, fminf(fmaxf(ty0 * dx1, dy0), dy1)));
  smin = fminf(smin, form_at(ca, cb, cc, fminf(fmaxf(tx0 * dy0, dx0), dx1), dy0));
  smin = fminf(smin, form_at(ca, cb, cc, fminf(fmaxf(tx0 * dy1, dx0), dx1), dy1));
  const float ex = fmaxf(fabsf(dx0), fabsf(dx1));
  const float ey = fmaxf(fabsf(dy0), fabsf(dy1));
  const float mag = 0.5f * (ca * ex * ex + cc * ey * ey) + fabsf(cb) * ex * ey;
  return !(smin > logf(255.f * op) + CULL_ABS + CULL_REL * mag);
}

// Bit q of the result: must this warp walk fragment sub * 32 + q of the
// stage? Lane l tests fragment l; fragments past n are never walked.
template <int BATCH>
__device__ __forceinline__ unsigned warp_keep_mask(const float4* stage, int sub,
                                                   int n, int lane, float x0,
                                                   float y0, float x1, float y1) {
  const int q = sub * 32 + lane;
  bool keep = false;
  if (q < n) keep = rect_may_take(stage[q], stage[BATCH + q], x0, y0, x1, y1);
  return __ballot_sync(FULL, keep);
}

}  // namespace rodygs
