// Tile compositing, backward (analytic, by recompute).
//
// Replaces the Pallas kernel `_bwd_kernel` launched by `rasterize_bwd_impl`
// (rodygs_tpu/render/tile_kernel.py). From the forward output O and its
// cotangent g (both [T, 8, 256]) it rebuilds each pixel's front-to-back
// traversal and emits, per fragment, d(mx, my, ca, cb, cc, op) and d(8
// features), summed over the tile's 256 pixels, into d_records [16, P].
// The suffix term sum_{j>i} w_j f_j.g is g.O minus the inclusive prefix of
// w f.g, as in the TPU kernel; the 0.99 alpha clamp has a zero subgradient.
// The stop decision is the forward's (common.cuh); the weight's
// transmittance is the forward's running product.
//
// Bound on the H100: instructions executed per (warp, fragment), and among
// them the reduction of a fragment's gradient values over the 256 pixels,
// not the recompute. The first design spent 14 values x 5 shuffle steps = 70
// SHFL + 70 FADD per (warp, fragment) that any lane touched, and 14 scalar
// shared stores by lane 0 for every fragment, touched or not; over 330 k
// fragments x 8 warps that alone is of the order of the kernel's whole time
// at the SM's 32 shuffle lanes per clock. What this design does about it:
//  - the walk takes the kept fragments two at a time (ILP), as the forward
//    does, and the warp reduces both together by a transpose through shared
//    memory: every lane parks its values in a [fragment, value][lane]
//    scratch of its warp (one store per value, no bank conflict), then lane
//    u * NGRAD + r adds the row of value r of fragment u with eight 128-bit
//    loads and 32 adds: per fragment 11 stores, 4 loads and 16 adds' worth
//    of scheduler slots where the trees took 140 and no shuffle at all. The rows
//    are 36 words apart, which spreads a quarter-warp's 128-bit loads over
//    all banks. (A transposing shuffle butterfly, 16 SHFL and 30 selects per
//    fragment, cannot share its steps between two fragments and was the
//    slower.)
//  - the warp reduces and stores only fragments that one of its lanes
//    touched and records them in a 32-bit mask; an untouched fragment costs
//    a warp nothing in the walk, and the cross-warp pass adds only the warps
//    whose bit is set, in warp order;
//  - the per-warp sums lie as s_grad[warp][fragment][value] with an odd
//    fragment stride, so the store of a fragment's sums and the cross-warp
//    pass's reads (neighbouring threads on neighbouring fragments of one
//    value, which is also the coalesced order of the output row) are both
//    free of bank conflicts, and a batch of 32 makes the (value, fragment)
//    split of a thread index two shifts;
//  - s_grad is double-buffered: batch b's cross-warp pass runs after the
//    next batch's barrier, so one __syncthreads per batch serves the staged
//    records, the reduction and the early-exit vote;
//  - 8x4 warps with the ballot cull, packed 128-bit staging with cp.async
//    and the normals template as in the forward (tile_common.cuh). With the
//    normal rows dead 11 values are reduced, not 14, three features and
//    three planes of O and g are never loaded.
// Tensor cores could take the 256-pixel sums as a product with a matrix of
// ones, but only as TF32 (ten mantissa bits) against a 5e-4 bar on sums of
// mixed sign; the sums stay FP32.
// A fragment lies in exactly one tile's range and each of its values has one
// writing thread, which adds lanes and warps in a fixed order: no atomics,
// and two runs give the same bits. The caller zeroes d_records first;
// columns outside every tile range and fragments after a tile's early exit
// keep 0.
#include "tile_common.cuh"

using namespace rodygs;

namespace {
constexpr int BATCH = 32;      // one ballot round; see the note on s_grad
constexpr int NVAL = 14;       // gradient values per fragment, normals live
constexpr int TSTRIDE = 36;    // words between rows of the transpose scratch
static_assert(ILP * NVAL <= 32, "one lane per (fragment, value) row");
}

template <bool NORMALS>
__global__ void __launch_bounds__(PIX, MIN_BLOCKS)
tile_bwd_kernel(const float* __restrict__ records, int P,
                const int* __restrict__ starts, const int* __restrict__ counts,
                const int* __restrict__ offset, int tiles_x,
                const float* __restrict__ out, const float* __restrict__ gout,
                float* __restrict__ d_records) {
  constexpr int NVEC = NORMALS ? 4 : 3;
  constexpr int NROWS = NORMALS ? 14 : 10;
  constexpr int NGRAD = NORMALS ? 14 : 11;   // values reduced per fragment
  constexpr int GSTRIDE = NORMALS ? 15 : 11; // odd: conflict-free both ways
  __shared__ float4 s_rec[2][NVEC * BATCH];
  __shared__ float s_grad[2][NWARP][BATCH * GSTRIDE];
  __shared__ unsigned s_touched[2][NWARP];
  // the warps' transpose scratch, NWARP x ILP x NGRAD x TSTRIDE words: dynamic,
  // because with live normals the block's total passes the 48 KB that
  // static shared memory may take
  extern __shared__ __align__(16) float s_tr[];
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
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

  // cotangent of this pixel and g.O; channels 4..6 are dead without normals
  float gpix[NUM_CHANNELS];
  float g_o = 0.f;
  const size_t pbase = (size_t)t * NUM_CHANNELS * PIX + pm.ly * TILE + pm.lx;
#pragma unroll
  for (int c = 0; c < NUM_CHANNELS; ++c) {
    if (!NORMALS && c >= 4 && c < 7) { gpix[c] = 0.f; continue; }
    gpix[c] = gout[pbase + c * PIX];
    g_o += gpix[c] * out[pbase + c * PIX];
  }

  float log_t = 0.f;
  float T = 1.f;
  float prefu = 0.f;
  bool done = false;

  if (num_batches > 0)
    stage_batch<NROWS, BATCH>(records, P, start, min(BATCH, count), s_rec[0], tid);
  for (int b = 0;; ++b) {
    cp_async_wait_all();
    // batch b has landed; every warp has parked batch b - 1's sums; nobody
    // still reads the stage or the s_grad half that batch b + 1 will use
    const int alive = __syncthreads_count(!done);
    const bool walk = b < num_batches && alive > 0;
    if (walk && b + 1 < num_batches)
      stage_batch<NROWS, BATCH>(records, P, start + (b + 1) * BATCH,
                                min(BATCH, count - (b + 1) * BATCH),
                                s_rec[(b + 1) & 1], tid);
    if (b > 0) {
      // cross-warp pass of batch b - 1: thread -> (value r, fragment q)
      const int pb = (b - 1) & 1;
      const int n_prev = min(BATCH, count - (b - 1) * BATCH);
      float* dst = d_records + start + (b - 1) * BATCH;
#pragma unroll
      for (int e0 = 0; e0 < NGRAD * BATCH; e0 += PIX) {
        const int e = e0 + tid;
        const int r = e / BATCH;
        const int q = e % BATCH;
        if (r < NGRAD && q < n_prev) {
          float s = 0.f;
#pragma unroll
          for (int w = 0; w < NWARP; ++w)
            if ((s_touched[pb][w] >> q) & 1u)
              s += s_grad[pb][w][q * GSTRIDE + r];
          // without normals value 10 is the alpha feature's, row 13
          const int row = (!NORMALS && r == 10) ? 13 : r;
          dst[(size_t)row * P + q] = s;
        }
      }
    }
    if (!walk) break;

    const int n = min(BATCH, count - b * BATCH);
    const float4* stage = s_rec[b & 1];
    float* my_grad = s_grad[b & 1][warp];
    float* my_tr = s_tr + warp * (ILP * NGRAD * TSTRIDE);
    unsigned touched = 0u;
    unsigned m = 0u;
    if (!__all_sync(FULL, done))
      m = warp_keep_mask<BATCH>(stage, 0, n, lane, rx0, ry0, rx1, ry1);
    while (m) {
      // the next ILP kept fragments, evaluated side by side: their alphas
      // and log1p terms do not depend on the carried transmittance, so the
      // long dependent chains overlap; only the carry itself is serial
      int q[ILP];
      bool pass[ILP], active[ILP];
      float dx[ILP], dy[ILP], G[ILP], unclamped[ILP], alpha[ILP];
      float v[ILP][NVAL];
      bool any_pass = false;
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const bool valid = m != 0u;          // uniform over the warp
        q[u] = valid ? __ffs(m) - 1 : q[0];
        m &= m - 1;
        const float4 v0 = stage[q[u]];
        const float4 v1 = stage[BATCH + q[u]];
        dx[u] = px - v0.x;
        dy[u] = py - v0.y;
        const float sigma = conic_sigma(v0.z, v0.w, v1.x, dx[u], dy[u]);
        G[u] = expf(-sigma);
        unclamped[u] = __fmul_rn(v1.y, G[u]);   // = unclamped_alpha()
        alpha[u] = fminf(ALPHA_MAX, unclamped[u]);
        pass[u] = valid && !done && sigma >= 0.f && alpha[u] >= ALPHA_EPS;
        any_pass |= pass[u];
        active[u] = false;
#pragma unroll
        for (int r = 0; r < NVAL; ++r) v[u][r] = 0.f;
      }
      if (any_pass) {
        float log1m[ILP];
#pragma unroll
        for (int u = 0; u < ILP; ++u) log1m[u] = log1pf(-alpha[u]);
#pragma unroll
        for (int u = 0; u < ILP; ++u) {
          if (!pass[u] || done) continue;
          const float log_t_incl = __fadd_rn(log_t, log1m[u]);  // log_t_step()
          if (!(log_t_incl >= LOG_T_EPS)) { done = true; continue; }
          active[u] = true;
          const float w = alpha[u] * T;
          const float4 v0 = stage[q[u]];
          const float cc = stage[BATCH + q[u]].x;
          const float ca = v0.z, cb = v0.w;
          const float4 f0 = stage[2 * BATCH + q[u]];
          float fg = gpix[0] * f0.x + gpix[1] * f0.y + gpix[2] * f0.z
                     + gpix[3] * f0.w;
          if (NORMALS) {
            const float4 f1 = stage[3 * BATCH + q[u]];
            fg += gpix[4] * f1.x + gpix[5] * f1.y + gpix[6] * f1.z
                  + gpix[7] * f1.w;
          } else {
            fg += gpix[7];
          }
          prefu += w * fg;
          const float suffix = g_o - prefu;
          // 1 - alpha >= 0.01: the fast division is 2 ulp off at most
          const float d_alpha = T * fg - __fdividef(suffix, 1.f - alpha[u]);
          const float d_unc = unclamped[u] < ALPHA_MAX ? d_alpha : 0.f;
          const float d_sigma = -unclamped[u] * d_unc;
          v[u][0] = d_sigma * -(ca * dx[u] + cb * dy[u]);
          v[u][1] = d_sigma * -(cc * dy[u] + cb * dx[u]);
          v[u][2] = d_sigma * 0.5f * dx[u] * dx[u];
          v[u][3] = d_sigma * dx[u] * dy[u];
          v[u][4] = d_sigma * 0.5f * dy[u] * dy[u];
          v[u][5] = G[u] * d_unc;
          v[u][6] = w * gpix[0];
          v[u][7] = w * gpix[1];
          v[u][8] = w * gpix[2];
          v[u][9] = w * gpix[3];
          if (NORMALS) {
            v[u][10] = w * gpix[4];
            v[u][11] = w * gpix[5];
            v[u][12] = w * gpix[6];
            v[u][13] = w * gpix[7];
          } else {
            v[u][10] = w * gpix[7];
          }
          T -= w;
          log_t = log_t_incl;
        }
      }
      bool hit[ILP];
      bool any_hit = false;
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        hit[u] = __any_sync(FULL, active[u]);
        any_hit |= hit[u];
        if (hit[u]) touched |= 1u << q[u];
      }
      if (!any_hit) continue;
      // transpose through the warp's scratch: row (u, r) holds value r of
      // fragment u for the 32 lanes; lane u * NGRAD + r adds its row
#pragma unroll
      for (int u = 0; u < ILP; ++u)
#pragma unroll
        for (int r = 0; r < NGRAD; ++r)
          my_tr[(u * NGRAD + r) * TSTRIDE + lane] = v[u][r];
      __syncwarp();
      if (lane < ILP * NGRAD) {
        const float4* row = reinterpret_cast<const float4*>(my_tr + lane * TSTRIDE);
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float4 x = row[k];
          sum += (x.x + x.y) + (x.z + x.w);
        }
        const int u_mine = lane / NGRAD;
        int q_mine = q[0];
        bool hit_mine = hit[0];
#pragma unroll
        for (int u = 1; u < ILP; ++u)
          if (u_mine == u) { q_mine = q[u]; hit_mine = hit[u]; }
        if (hit_mine) my_grad[q_mine * GSTRIDE + (lane - u_mine * NGRAD)] = sum;
      }
      __syncwarp();   // the scratch is rewritten at the next round
    }
    if (lane == 0) s_touched[b & 1][warp] = touched;
  }
}

// Bytes of the warps' transpose scratch, the kernel's dynamic shared memory.
template <bool NORMALS>
constexpr int scratch_bytes() {
  return NWARP * ILP * (NORMALS ? 14 : 11) * TSTRIDE * (int)sizeof(float);
}

// Static and dynamic shared memory together pass 48 KB, which a kernel must
// opt into: once per instantiation and device, not per launch.
template <bool NORMALS>
static cudaError_t allow_scratch() {
  static int configured_device = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || device == configured_device) return err;
  err = cudaFuncSetAttribute(tile_bwd_kernel<NORMALS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             scratch_bytes<NORMALS>());
  if (err == cudaSuccess) configured_device = device;
  return err;
}

template <bool NORMALS>
static cudaError_t launch_bwd(const float* records, int P, const int* starts,
                              const int* counts, const int* offset,
                              int num_tiles, int tiles_x, const float* out,
                              const float* gout, float* d_records,
                              cudaStream_t stream) {
  const cudaError_t err = allow_scratch<NORMALS>();
  if (err != cudaSuccess) return err;
  constexpr int scratch = scratch_bytes<NORMALS>();
  tile_bwd_kernel<NORMALS><<<num_tiles, PIX, scratch, stream>>>(
      records, P, starts, counts, offset, tiles_x, out, gout, d_records);
  return cudaGetLastError();
}

extern "C" int rodygs_tile_bwd(const float* records, int P, const int* starts,
                               const int* counts, const int* offset,
                               int num_tiles, int tiles_x, int normals,
                               const float* out, const float* gout,
                               float* d_records, cudaStream_t stream) {
  if (num_tiles <= 0) return 0;
  return (int)(normals
                   ? launch_bwd<true>(records, P, starts, counts, offset,
                                      num_tiles, tiles_x, out, gout, d_records,
                                      stream)
                   : launch_bwd<false>(records, P, starts, counts, offset,
                                       num_tiles, tiles_x, out, gout,
                                       d_records, stream));
}

// Blocks of this kernel that one SM holds at once, by the runtime's own
// count (registers, static and dynamic shared memory, threads); < 0 on error.
template <bool NORMALS>
static int blocks_per_sm() {
  int blocks = 0;
  cudaError_t err = allow_scratch<NORMALS>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, tile_bwd_kernel<NORMALS>, PIX, scratch_bytes<NORMALS>());
  return err == cudaSuccess ? blocks : -(int)err;
}

extern "C" int rodygs_tile_bwd_blocks_per_sm(int normals) {
  return normals ? blocks_per_sm<true>() : blocks_per_sm<false>();
}
