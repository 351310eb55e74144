// Gaussian preprocessing, forward and backward: render/preprocess.py's
// projection stage (view and clip transforms, EWA covariance, conic,
// screen radius, alpha-cut extents, SH colour, view-space normal) as one
// thread a Gaussian.
//
// Replaces no TPU kernel: the JAX package's preprocess is plain jnp, which
// XLA fuses into a few programs. The port's plain version (preprocess_plain)
// runs the same formulas as ~726 small launches forward and ~1,340 through
// autograd backward in the two renders of a joint iteration (on the H100,
// kubric512.joint), where the host's dispatch sets the pace; this kernel
// exists to cut those launches. Bound on the H100: memory, ~120 bytes a
// Gaussian forward (its parameters in, the [R, N] rows out) and ~340
// backward at SH degree 0 (the parameters and the row cotangents in, the
// gradients out, the [N, K, 3] SH gradient written whole); the arithmetic,
// a few hundred FP32 operations a Gaussian, is far under the FP32 rate.
//
//  - Forward: every value takes the plain version's IEEE operations in the
//    plain version's order, written with explicitly rounded intrinsics
//    (__fmul_rn, __fadd_rn, __fsub_rn, __frcp_rn, __fdiv_rn, __fsqrt_rn),
//    which nvcc never contracts into FMAs; torch's `x / t` for a Python x is
//    a reciprocal times x, and so it is here. tanf, logf and ceilf are the
//    functions torch's kernels call. So radius, visibility, the extents and
//    with them the binning are the plain version's on the card, and the
//    float outputs its bits.
//  - Backward: the inputs only are saved; the thread recomputes the forward
//    (the same code) and applies the chain rule that
//    render/preprocess.py::preprocess_backward_plain writes in torch ops,
//    term for term, in the same rounded operations and order: the float32
//    chain is ill-conditioned for elongated Gaussians (the quaternion and
//    scale gradients of either lie ~5e-5 of their max from a float64
//    evaluation), so an FMA-contracted kernel would depart from its plain
//    version by as much; written this way the two give the same bits, the
//    camera's sums (another order) aside. Conventions are autograd's of
//    the plain version: nothing through a where-branch not taken (near cull,
//    det <= 0, a dead slot's quaternion), the colour clamp at 0 (>= passes)
//    and the frustum clamp (a tie passes half, as torch.maximum does), and
//    nothing through radius, extents, visibility or the normal's axis choice.
//    SH coefficients above the active degree get zeros, written by the
//    block over its contiguous range, coalesced.
//  - The camera's gradient (w2c rows 0-2, full_proj rows 0, 1 and 3, campos:
//    27 numbers) is a sum over N: each block sums its threads' terms in a
//    fixed order (warp shuffles, then the warps in order) into one partial
//    row, and rodygs_preprocess_reduce sums the rows in a fixed order. No
//    atomics: two runs give the same bits.
//  - Templated on the SH degree (0-3, or -1 for precomputed colours, which
//    evaluate no SH): five instantiations each way. Whether `alive` is given
//    and whether the camera takes a gradient are branches every thread
//    takes alike; as template parameters they quadrupled the build's time
//    (every run builds anew, inside its set-up) and gained nothing, since
//    the registers, and with them the blocks an SM holds, stay the same. A
//    cotangent or gradient pointer that is null is read as zeros or not
//    written.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;     // render/preprocess.py: BWD_THREADS
constexpr int CAM_PARTIALS = 27; // render/preprocess.py: CAM_PARTIALS

// torch multiplies a float32 tensor by a Python float rounded to float32
#define F32(x) static_cast<float>(x)
constexpr float NEAR_CULL_Z = F32(0.2);
constexpr float COV2D_DILATION = F32(0.3);
constexpr float SH_C0 = F32(0.28209479177387814);
constexpr float SH_C1 = F32(0.4886025119029199);
__constant__ float SH_C2[5] = {
    F32(1.0925484305920792), F32(-1.0925484305920792),
    F32(0.31539156525252005), F32(-1.0925484305920792),
    F32(0.5462742152960396)};
__constant__ float SH_C3[7] = {
    F32(-0.5900435899266435), F32(2.890611442640554),
    F32(-0.4570457994644658), F32(0.3731763325901154),
    F32(-0.4570457994644658), F32(1.445305721320277),
    F32(-0.5900435899266435)};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// ((r0 x + r1 y) + r2 z) + r3, as the plain version sums a matrix row
__device__ __forceinline__ float row4(const float* r, float x, float y,
                                      float z) {
  return add(add(add(mul(r[0], x), mul(r[1], y)), mul(r[2], z)), r[3]);
}

struct Camera {
  float V[3][4];      // w2c rows 0-2
  float F[3][4];      // full_proj rows 0, 1, 3
  float pos[3];
  float focal_x, focal_y, lim_x, lim_y;
};

__device__ Camera load_camera(const float* w2c, const float* full_proj,
                              const float* campos, const float* fovx,
                              const float* fovy, int W, int H) {
  Camera c;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c.V[i][j] = w2c[i * 4 + j];
      c.F[i][j] = full_proj[(i == 2 ? 3 : i) * 4 + j];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i) c.pos[i] = campos[i];
  const float tan_x = tanf(mul(fovx[0], 0.5f));
  const float tan_y = tanf(mul(fovy[0], 0.5f));
  c.focal_x = mul(__frcp_rn(mul(tan_x, 2.0f)), static_cast<float>(W));
  c.focal_y = mul(__frcp_rn(mul(tan_y, 2.0f)), static_cast<float>(H));
  c.lim_x = mul(tan_x, F32(1.3));
  c.lim_y = mul(tan_y, F32(1.3));
  return c;
}

// The forward's values that its outputs and the backward read.
struct Proj {
  float m[3], s[3], q[4];
  float depth, hx, hy, inv_w, px, py;
  bool depth_ok, det_ok;
  float tz, u[2], tc[2], inv_z, inv_z2, j00, j02, j11, j12;
  float two_s, R[3][3], s2[3], C[3][3], T[2][3], U[2][3];
  float a, b, c, inv_det, con[3], radius_f;
  int axis;           // the shortest axis: a column of R
  float ax[3], nv[3], flip;
};

__device__ __forceinline__ void project(Proj& p, const Camera& cam,
                                        const float* means,
                                        const float* scales,
                                        const float* quats, bool alive,
                                        float smod, int W, int H, int i) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.m[k] = means[3 * i + k];
    p.s[k] = mul(scales[3 * i + k], smod);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) p.q[k] = quats[4 * i + k];
  if (!alive) p.q[0] = 1.0f, p.q[1] = p.q[2] = p.q[3] = 0.0f;
  const float mx = p.m[0], my = p.m[1], mz = p.m[2];

  const float tx = row4(cam.V[0], mx, my, mz);
  const float ty = row4(cam.V[1], mx, my, mz);
  p.depth = row4(cam.V[2], mx, my, mz);
  p.depth_ok = p.depth >= NEAR_CULL_Z;
  p.hx = row4(cam.F[0], mx, my, mz);
  p.hy = row4(cam.F[1], mx, my, mz);
  const float hw = row4(cam.F[2], mx, my, mz);
  p.inv_w = __frcp_rn(p.depth_ok ? add(hw, F32(1e-7)) : 1.0f);
  p.px = mul(sub(mul(add(mul(p.hx, p.inv_w), 1.0f), static_cast<float>(W)),
                 1.0f), 0.5f);
  p.py = mul(sub(mul(add(mul(p.hy, p.inv_w), 1.0f), static_cast<float>(H)),
                 1.0f), 0.5f);

  p.tz = p.depth_ok ? p.depth : 1.0f;
  p.u[0] = __fdiv_rn(tx, p.tz);
  p.u[1] = __fdiv_rn(ty, p.tz);
  p.tc[0] = mul(fminf(fmaxf(p.u[0], -cam.lim_x), cam.lim_x), p.tz);
  p.tc[1] = mul(fminf(fmaxf(p.u[1], -cam.lim_y), cam.lim_y), p.tz);
  p.inv_z = __frcp_rn(p.tz);
  p.inv_z2 = mul(p.inv_z, p.inv_z);
  p.j00 = mul(cam.focal_x, p.inv_z);
  p.j02 = mul(mul(-cam.focal_x, p.tc[0]), p.inv_z2);
  p.j11 = mul(cam.focal_y, p.inv_z);
  p.j12 = mul(mul(-cam.focal_y, p.tc[1]), p.inv_z2);

  const float qw = p.q[0], qx = p.q[1], qy = p.q[2], qz = p.q[3];
  const float qn2 = add(add(add(add(mul(qw, qw), mul(qx, qx)), mul(qy, qy)),
                            mul(qz, qz)), F32(1e-24));
  p.two_s = mul(__frcp_rn(qn2), 2.0f);
  const float ts = p.two_s;
  p.R[0][0] = sub(1.0f, mul(ts, add(mul(qy, qy), mul(qz, qz))));
  p.R[0][1] = mul(ts, sub(mul(qx, qy), mul(qz, qw)));
  p.R[0][2] = mul(ts, add(mul(qx, qz), mul(qy, qw)));
  p.R[1][0] = mul(ts, add(mul(qx, qy), mul(qz, qw)));
  p.R[1][1] = sub(1.0f, mul(ts, add(mul(qx, qx), mul(qz, qz))));
  p.R[1][2] = mul(ts, sub(mul(qy, qz), mul(qx, qw)));
  p.R[2][0] = mul(ts, sub(mul(qx, qz), mul(qy, qw)));
  p.R[2][1] = mul(ts, add(mul(qy, qz), mul(qx, qw)));
  p.R[2][2] = sub(1.0f, mul(ts, add(mul(qx, qx), mul(qy, qy))));

#pragma unroll
  for (int k = 0; k < 3; ++k) p.s2[k] = mul(p.s[k], p.s[k]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j) {
      p.C[i][j] = add(add(mul(mul(p.R[i][0], p.R[j][0]), p.s2[0]),
                          mul(mul(p.R[i][1], p.R[j][1]), p.s2[1])),
                      mul(mul(p.R[i][2], p.R[j][2]), p.s2[2]));
      p.C[j][i] = p.C[i][j];
    }

#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.T[0][k] = add(mul(p.j00, cam.V[0][k]), mul(p.j02, cam.V[2][k]));
    p.T[1][k] = add(mul(p.j11, cam.V[1][k]), mul(p.j12, cam.V[2][k]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      p.U[r][k] = add(add(mul(p.T[r][0], p.C[0][k]), mul(p.T[r][1], p.C[1][k])),
                      mul(p.T[r][2], p.C[2][k]));
  p.a = add(add(add(mul(p.U[0][0], p.T[0][0]), mul(p.U[0][1], p.T[0][1])),
                mul(p.U[0][2], p.T[0][2])), COV2D_DILATION);
  p.b = add(add(mul(p.U[0][0], p.T[1][0]), mul(p.U[0][1], p.T[1][1])),
            mul(p.U[0][2], p.T[1][2]));
  p.c = add(add(add(mul(p.U[1][0], p.T[1][0]), mul(p.U[1][1], p.T[1][1])),
                mul(p.U[1][2], p.T[1][2])), COV2D_DILATION);

  const float det = sub(mul(p.a, p.c), mul(p.b, p.b));
  p.det_ok = det > 0.0f;
  p.inv_det = __frcp_rn(p.det_ok ? det : 1.0f);
  p.con[0] = mul(p.c, p.inv_det);
  p.con[1] = mul(-p.b, p.inv_det);
  p.con[2] = mul(p.a, p.inv_det);
  const float mid = mul(add(p.a, p.c), 0.5f);
  const float lam1 = add(mid, __fsqrt_rn(fmaxf(sub(mul(mid, mid), det),
                                               F32(0.1))));
  p.radius_f = ceilf(mul(__fsqrt_rn(lam1), 3.0f));

  const bool x_short = p.s[0] <= fminf(p.s[1], p.s[2]);
  const bool y_short = p.s[1] <= p.s[2];
  p.axis = x_short ? 0 : (y_short ? 1 : 2);
#pragma unroll
  for (int r = 0; r < 3; ++r)
    p.ax[r] = x_short ? p.R[r][0] : (y_short ? p.R[r][1] : p.R[r][2]);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    p.nv[k] = add(add(mul(cam.V[k][0], p.ax[0]), mul(cam.V[k][1], p.ax[1])),
                  mul(cam.V[k][2], p.ax[2]));
  p.flip = p.nv[2] > 0.0f ? -1.0f : 1.0f;
}

// The unit view direction (x, y, z) and 1 / |m - campos|.
__device__ __forceinline__ void view_dir(const Proj& p, const Camera& cam,
                                         float* dir, float& dn) {
  const float dx = sub(p.m[0], cam.pos[0]);
  const float dy = sub(p.m[1], cam.pos[1]);
  const float dz = sub(p.m[2], cam.pos[2]);
  dn = __frcp_rn(__fsqrt_rn(add(add(add(mul(dx, dx), mul(dy, dy)),
                                    mul(dz, dz)), F32(1e-16))));
  dir[0] = mul(dx, dn);
  dir[1] = mul(dy, dn);
  dir[2] = mul(dz, dn);
}

// SH + 0.5 of channel ch before the clamp, in the plain version's order;
// sh = the Gaussian's [K, 3] coefficients.
template <int DEG>
__device__ __forceinline__ float sh_eval(const float* sh, int ch,
                                         const float* d) {
  const float x = d[0], y = d[1], z = d[2];
  float o = mul(SH_C0, sh[ch]);
  if (DEG > 0) {
    o = sub(add(sub(o, mul(mul(y, SH_C1), sh[3 + ch])),
                mul(mul(z, SH_C1), sh[6 + ch])),
            mul(mul(x, SH_C1), sh[9 + ch]));
  }
  if (DEG > 1) {
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
    o = add(o, mul(mul(xy, SH_C2[0]), sh[12 + ch]));
    o = add(o, mul(mul(yz, SH_C2[1]), sh[15 + ch]));
    o = add(o, mul(mul(sub(sub(mul(zz, 2.0f), xx), yy), SH_C2[2]),
                   sh[18 + ch]));
    o = add(o, mul(mul(xz, SH_C2[3]), sh[21 + ch]));
    o = add(o, mul(mul(sub(xx, yy), SH_C2[4]), sh[24 + ch]));
    if (DEG > 2) {
      o = add(o, mul(mul(mul(y, SH_C3[0]), sub(mul(xx, 3.0f), yy)),
                     sh[27 + ch]));
      o = add(o, mul(mul(mul(xy, SH_C3[1]), z), sh[30 + ch]));
      o = add(o, mul(mul(mul(y, SH_C3[2]), sub(sub(mul(zz, 4.0f), xx), yy)),
                     sh[33 + ch]));
      o = add(o, mul(mul(mul(z, SH_C3[3]),
                         sub(sub(mul(zz, 2.0f), mul(xx, 3.0f)),
                             mul(yy, 3.0f))),
                     sh[36 + ch]));
      o = add(o, mul(mul(mul(x, SH_C3[4]), sub(sub(mul(zz, 4.0f), xx), yy)),
                     sh[39 + ch]));
      o = add(o, mul(mul(mul(z, SH_C3[5]), sub(xx, yy)), sh[42 + ch]));
      o = add(o, mul(mul(mul(x, SH_C3[6]), sub(xx, mul(yy, 3.0f))),
                     sh[45 + ch]));
    }
  }
  return add(o, 0.5f);
}

// Which derivative of each SH function is not identically 0 (by x, y, z).
__device__ constexpr bool DB_HAS[16][3] = {
    {0, 0, 0}, {0, 1, 0}, {0, 0, 1}, {1, 0, 0}, {1, 1, 0}, {0, 1, 1},
    {1, 1, 1}, {1, 0, 1}, {1, 1, 0}, {1, 1, 0}, {1, 1, 1}, {1, 1, 1},
    {1, 1, 1}, {1, 1, 1}, {1, 1, 1}, {1, 1, 0}};

// The basis at (x, y, z), and its derivatives where DB_HAS says, in
// preprocess_backward_plain's operations (_sh_basis); a constant that the
// Python side forms from two Python floats is formed in double here too.
template <int DEG>
__device__ __forceinline__ void sh_basis(const float* d, float* b,
                                         float (*db)[3]) {
  const float x = d[0], y = d[1], z = d[2];
  b[0] = SH_C0;
  if (DEG > 0) {
    b[1] = mul(y, F32(-0.4886025119029199));
    b[2] = mul(z, SH_C1);
    b[3] = mul(x, F32(-0.4886025119029199));
    db[1][1] = F32(-0.4886025119029199);
    db[2][2] = SH_C1;
    db[3][0] = F32(-0.4886025119029199);
  }
  if (DEG > 1) {
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
    const float* c2 = SH_C2;
    b[4] = mul(xy, c2[0]);
    b[5] = mul(yz, c2[1]);
    b[6] = mul(sub(sub(mul(zz, 2.0f), xx), yy), c2[2]);
    b[7] = mul(xz, c2[3]);
    b[8] = mul(sub(xx, yy), c2[4]);
    db[4][0] = mul(y, c2[0]);  db[4][1] = mul(x, c2[0]);
    db[5][1] = mul(z, c2[1]);  db[5][2] = mul(y, c2[1]);
    db[6][0] = mul(x, F32(-2.0 * 0.31539156525252005));
    db[6][1] = mul(y, F32(-2.0 * 0.31539156525252005));
    db[6][2] = mul(z, F32(4.0 * 0.31539156525252005));
    db[7][0] = mul(z, c2[3]);  db[7][2] = mul(x, c2[3]);
    db[8][0] = mul(x, F32(2.0 * 0.5462742152960396));
    db[8][1] = mul(y, F32(-2.0 * 0.5462742152960396));
    if (DEG > 2) {
      const float* c3 = SH_C3;
      b[9] = mul(mul(y, c3[0]), sub(mul(xx, 3.0f), yy));
      b[10] = mul(mul(xy, c3[1]), z);
      b[11] = mul(mul(y, c3[2]), sub(sub(mul(zz, 4.0f), xx), yy));
      b[12] = mul(mul(z, c3[3]),
                  sub(sub(mul(zz, 2.0f), mul(xx, 3.0f)), mul(yy, 3.0f)));
      b[13] = mul(mul(x, c3[4]), sub(sub(mul(zz, 4.0f), xx), yy));
      b[14] = mul(mul(z, c3[5]), sub(xx, yy));
      b[15] = mul(mul(x, c3[6]), sub(xx, mul(yy, 3.0f)));
      db[9][0] = mul(xy, F32(-0.5900435899266435 * 6.0));
      db[9][1] = mul(sub(xx, yy), F32(-0.5900435899266435 * 3.0));
      db[10][0] = mul(yz, c3[1]);
      db[10][1] = mul(xz, c3[1]);
      db[10][2] = mul(xy, c3[1]);
      db[11][0] = mul(xy, F32(-2.0 * -0.4570457994644658));
      db[11][1] = mul(sub(sub(mul(zz, 4.0f), xx), mul(yy, 3.0f)), c3[2]);
      db[11][2] = mul(yz, F32(8.0 * -0.4570457994644658));
      db[12][0] = mul(xz, F32(-6.0 * 0.3731763325901154));
      db[12][1] = mul(yz, F32(-6.0 * 0.3731763325901154));
      db[12][2] = mul(sub(sub(mul(zz, 6.0f), mul(xx, 3.0f)), mul(yy, 3.0f)),
                      c3[3]);
      db[13][0] = mul(sub(sub(mul(zz, 4.0f), mul(xx, 3.0f)), yy), c3[4]);
      db[13][1] = mul(xy, F32(-2.0 * -0.4570457994644658));
      db[13][2] = mul(xz, F32(8.0 * -0.4570457994644658));
      db[14][0] = mul(xz, F32(2.0 * 1.445305721320277));
      db[14][1] = mul(yz, F32(-2.0 * 1.445305721320277));
      db[14][2] = mul(sub(xx, yy), c3[5]);
      db[15][0] = mul(sub(xx, yy), F32(-0.5900435899266435 * 3.0));
      db[15][1] = mul(xy, F32(-6.0 * -0.5900435899266435));
    }
  }
}

template <int DEG>
__global__ void __launch_bounds__(THREADS)
preprocess_fwd_kernel(const float* __restrict__ means,
                      const float* __restrict__ scales,
                      const float* __restrict__ quats,
                      const float* __restrict__ shs, int n, int K,
                      const uint8_t* __restrict__ alive,
                      const float* __restrict__ colors,
                      const float* __restrict__ opac,
                      const float* w2c, const float* full_proj,
                      const float* campos, const float* fovx,
                      const float* fovy, int W, int H, float smod,
                      float* __restrict__ mean2d, float* __restrict__ conic,
                      float* __restrict__ depth, float* __restrict__ rgb,
                      float* __restrict__ normal, int* __restrict__ radius,
                      uint8_t* __restrict__ visible,
                      float* __restrict__ ext) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const Camera cam = load_camera(w2c, full_proj, campos, fovx, fovy, W, H);
  const bool live = alive == nullptr || alive[i];
  Proj p;
  project(p, cam, means, scales, quats, live, smod, W, H, i);
  const size_t N = n;

  mean2d[i] = p.px;
  mean2d[N + i] = p.py;
#pragma unroll
  for (int k = 0; k < 3; ++k) conic[k * N + i] = p.con[k];
  depth[i] = p.depth;
  if constexpr (DEG >= 0) {
    float d[3], dn;
    view_dir(p, cam, d, dn);
    const float* sh = shs + (size_t)i * K * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      rgb[ch * N + i] = fmaxf(sh_eval<DEG>(sh, ch, d), 0.0f);
  } else {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) rgb[ch * N + i] = colors[3 * i + ch];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) normal[k * N + i] = p.nv[k] * p.flip;

  const bool vis = p.depth_ok && p.det_ok && p.radius_f > 0.0f && live;
  radius[i] = vis ? static_cast<int>(p.radius_f) : 0;
  visible[i] = vis;
  const float op_safe = fmaxf(opac[i], F32(1e-12));
  const float t_cut = fmaxf(mul(logf(mul(op_safe, 255.0f)), 2.0f), 0.0f);
  ext[i] = add(mul(__fsqrt_rn(mul(t_cut, p.a)), F32(1.00001)), F32(1e-3));
  ext[N + i] = add(mul(__fsqrt_rn(mul(t_cut, p.c)), F32(1.00001)), F32(1e-3));
}

// Row r of a cotangent [R, N] with row stride ld; zero where none is given.
__device__ __forceinline__ float cot(const float* g, size_t ld, int r,
                                     int i) {
  return g ? g[r * ld + i] : 0.0f;
}

template <int DEG>
__global__ void __launch_bounds__(THREADS)
preprocess_bwd_kernel(const float* __restrict__ means,
                      const float* __restrict__ scales,
                      const float* __restrict__ quats,
                      const float* __restrict__ shs, int n, int K,
                      const uint8_t* __restrict__ alive,
                      const float* w2c, const float* full_proj,
                      const float* campos, const float* fovx,
                      const float* fovy, int W, int H, float smod,
                      const float* __restrict__ g_mean2d, int ld_mean2d,
                      const float* __restrict__ g_conic, int ld_conic,
                      const float* __restrict__ g_depth,
                      const float* __restrict__ g_rgb, int ld_rgb,
                      const float* __restrict__ g_normal, int ld_normal,
                      float* __restrict__ d_means,
                      float* __restrict__ d_scales,
                      float* __restrict__ d_quats,
                      float* __restrict__ d_shs,
                      float* __restrict__ partial) {
  constexpr int NC = DEG >= 0 ? (DEG + 1) * (DEG + 1) : 0;
  const int i0 = blockIdx.x * THREADS;
  const int i = i0 + threadIdx.x;
  if (DEG >= 0 && d_shs != nullptr) {
    // zeros above the active degree, over the block's contiguous range
    const int nb = min(THREADS, n - i0);
    float* base = d_shs + (size_t)i0 * K * 3;
    for (int e = threadIdx.x; e < nb * K * 3; e += THREADS)
      if ((e / 3) % K >= NC) base[e] = 0.0f;
  }
  float cg[CAM_PARTIALS];   // this thread's terms of the camera's gradient
#pragma unroll
  for (int k = 0; k < CAM_PARTIALS; ++k) cg[k] = 0.0f;

  if (i < n) {
    const Camera cam = load_camera(w2c, full_proj, campos, fovx, fovy, W, H);
    const bool live = alive == nullptr || alive[i];
    Proj p;
    project(p, cam, means, scales, quats, live, smod, W, H, i);
    const float fx = cam.focal_x, fy = cam.focal_y;

    // mean2d: px = ((hx inv_w + 1) W - 1) / 2, inv_w = 1 / (hw + 1e-7)
    const float hW = 0.5f * W, hH = 0.5f * H;
    const float gpx = cot(g_mean2d, ld_mean2d, 0, i);
    const float gpy = cot(g_mean2d, ld_mean2d, 1, i);
    const float g_hx = mul(mul(gpx, hW), p.inv_w);
    const float g_hy = mul(mul(gpy, hH), p.inv_w);
    const float g_iw = add(mul(mul(gpx, hW), p.hx), mul(mul(gpy, hH), p.hy));
    const float g_hw = p.depth_ok ? mul(mul(-g_iw, p.inv_w), p.inv_w) : 0.0f;

    // conic = (c, -b, a) / det
    const float gca = cot(g_conic, ld_conic, 0, i);
    const float gcb = cot(g_conic, ld_conic, 1, i);
    const float gcc = cot(g_conic, ld_conic, 2, i);
    const float g_idet = add(sub(mul(gca, p.c), mul(gcb, p.b)), mul(gcc, p.a));
    const float g_det =
        p.det_ok ? mul(mul(-g_idet, p.inv_det), p.inv_det) : 0.0f;
    const float g_a = add(mul(gcc, p.inv_det), mul(g_det, p.c));
    const float g_b = sub(mul(-gcb, p.inv_det), mul(mul(g_det, 2.0f), p.b));
    const float g_c = add(mul(gca, p.inv_det), mul(g_det, p.a));

    // a = u0.t0 + 0.3, b = u0.t1, c = u1.t1 + 0.3, u_r = t_r C
    float g_u0[3], g_u1[3], g_t0[3], g_t1[3], gC[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_u0[k] = add(mul(g_a, p.T[0][k]), mul(g_b, p.T[1][k]));
      g_u1[k] = mul(g_c, p.T[1][k]);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_t0[k] = add(add(add(mul(g_a, p.U[0][k]), mul(g_u0[0], p.C[k][0])),
                        mul(g_u0[1], p.C[k][1])), mul(g_u0[2], p.C[k][2]));
      g_t1[k] = add(add(add(add(mul(g_b, p.U[0][k]), mul(g_c, p.U[1][k])),
                            mul(g_u1[0], p.C[k][0])), mul(g_u1[1], p.C[k][1])),
                    mul(g_u1[2], p.C[k][2]));
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k)
        gC[r][k] = add(mul(p.T[0][r], g_u0[k]), mul(p.T[1][r], g_u1[k]));

    // t0 = j00 V0 + j02 V2, t1 = j11 V1 + j12 V2
    const float(*V)[4] = cam.V;
    auto dot3 = [](const float* g, const float* v) {
      return add(add(mul(g[0], v[0]), mul(g[1], v[1])), mul(g[2], v[2]));
    };
    const float g_j00 = dot3(g_t0, V[0]);
    const float g_j02 = dot3(g_t0, V[2]);
    const float g_j11 = dot3(g_t1, V[1]);
    const float g_j12 = dot3(g_t1, V[2]);
    float gV[3][3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gV[0][k] = mul(g_t0[k], p.j00);
      gV[1][k] = mul(g_t1[k], p.j11);
      gV[2][k] = add(mul(g_t0[k], p.j02), mul(g_t1[k], p.j12));
    }

    // the Jacobian from tz and the clamped frustum coordinates
    const float g_iz2 = -add(mul(mul(g_j02, fx), p.tc[0]),
                             mul(mul(g_j12, fy), p.tc[1]));
    const float g_iz = add(add(mul(g_j00, fx), mul(g_j11, fy)),
                           mul(mul(p.inv_z, 2.0f), g_iz2));
    const float g_tc[2] = {mul(mul(-g_j02, fx), p.inv_z2),
                           mul(mul(-g_j12, fy), p.inv_z2)};
    const float lim[2] = {cam.lim_x, cam.lim_y};
    float g_tz = mul(mul(-g_iz, p.inv_z), p.inv_z);
    float g_tv[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float u = p.u[k];
      const float v = fmaxf(u, -lim[k]);
      const float inside =
          (u > -lim[k] ? 1.0f : (u == -lim[k] ? 0.5f : 0.0f))
          * (v < lim[k] ? 1.0f : (v == lim[k] ? 0.5f : 0.0f));
      g_tz = add(g_tz, mul(g_tc[k], fminf(v, lim[k])));
      const float g_u = mul(mul(g_tc[k], p.tz), inside);
      g_tv[k] = __fdiv_rn(g_u, p.tz);
      g_tz = sub(g_tz, __fdiv_rn(mul(g_u, u), p.tz));
    }
    const float g_dep = add(cot(g_depth, 0, 0, i), p.depth_ok ? g_tz : 0.0f);

    // normal = flip * V3 ax, ax the shortest axis's column of R
    float gR[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k) gR[r][k] = 0.0f;
    if (g_normal != nullptr) {
      float g_nv[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        g_nv[k] = g_normal[k * (size_t)ld_normal + i] * p.flip;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float g_ax = add(add(mul(g_nv[0], V[0][j]), mul(g_nv[1], V[1][j])),
                               mul(g_nv[2], V[2][j]));
#pragma unroll
        for (int k = 0; k < 3; ++k)
          gR[j][k] = add(gR[j][k], k == p.axis ? g_ax : 0.0f);
#pragma unroll
        for (int r = 0; r < 3; ++r) gV[r][j] = add(gV[r][j], mul(g_nv[r], p.ax[j]));
      }
    }

    // Sigma = R diag(s^2) R^T: dR = (gC + gC^T) R diag(s^2)
    float g_s[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int r = 0; r < 3; ++r)
        gR[r][k] = add(gR[r][k],
                       mul(p.s2[k],
                           add(add(mul(add(gC[r][0], gC[0][r]), p.R[0][k]),
                                   mul(add(gC[r][1], gC[1][r]), p.R[1][k])),
                               mul(add(gC[r][2], gC[2][r]), p.R[2][k]))));
      float g_s2 = 0.0f;
#pragma unroll
      for (int r = 0; r < 3; ++r)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          g_s2 = add(g_s2, mul(mul(gC[r][j], p.R[r][k]), p.R[j][k]));
      g_s[k] = mul(mul(mul(g_s2, 2.0f), p.s[k]), smod);
    }

    // R = I + two_s P(q), two_s = 2 / |q|^2
    const float qw = p.q[0], qx = p.q[1], qy = p.q[2], qz = p.q[3];
    const float(*g)[3] = gR;
    const float ts = p.two_s;
    float acc = mul(-g[0][0], add(mul(qy, qy), mul(qz, qz)));
    acc = add(acc, mul(g[0][1], sub(mul(qx, qy), mul(qz, qw))));
    acc = add(acc, mul(g[0][2], add(mul(qx, qz), mul(qy, qw))));
    acc = add(acc, mul(g[1][0], add(mul(qx, qy), mul(qz, qw))));
    acc = sub(acc, mul(g[1][1], add(mul(qx, qx), mul(qz, qz))));
    acc = add(acc, mul(g[1][2], sub(mul(qy, qz), mul(qx, qw))));
    acc = add(acc, mul(g[2][0], sub(mul(qx, qz), mul(qy, qw))));
    acc = add(acc, mul(g[2][1], add(mul(qy, qz), mul(qx, qw))));
    acc = sub(acc, mul(g[2][2], add(mul(qx, qx), mul(qy, qy))));
    const float g_qn2 = mul(mul(mul(acc, -0.5f), ts), ts);
    float g_q[4];
    acc = add(mul(-g[0][1], qz), mul(g[0][2], qy));
    acc = add(acc, mul(g[1][0], qz));
    acc = sub(acc, mul(g[1][2], qx));
    acc = sub(acc, mul(g[2][0], qy));
    acc = add(acc, mul(g[2][1], qx));
    g_q[0] = mul(ts, acc);
    acc = add(mul(g[0][1], qy), mul(g[0][2], qz));
    acc = add(acc, mul(g[1][0], qy));
    acc = sub(acc, mul(mul(g[1][1], 2.0f), qx));
    acc = sub(acc, mul(g[1][2], qw));
    acc = add(acc, mul(g[2][0], qz));
    acc = add(acc, mul(g[2][1], qw));
    acc = sub(acc, mul(mul(g[2][2], 2.0f), qx));
    g_q[1] = mul(ts, acc);
    acc = add(mul(mul(g[0][0], -2.0f), qy), mul(g[0][1], qx));
    acc = add(acc, mul(g[0][2], qw));
    acc = add(acc, mul(g[1][0], qx));
    acc = add(acc, mul(g[1][2], qz));
    acc = sub(acc, mul(g[2][0], qw));
    acc = add(acc, mul(g[2][1], qz));
    acc = sub(acc, mul(mul(g[2][2], 2.0f), qy));
    g_q[2] = mul(ts, acc);
    acc = sub(mul(mul(g[0][0], -2.0f), qz), mul(g[0][1], qw));
    acc = add(acc, mul(g[0][2], qx));
    acc = add(acc, mul(g[1][0], qw));
    acc = sub(acc, mul(mul(g[1][1], 2.0f), qz));
    acc = add(acc, mul(g[1][2], qy));
    acc = add(acc, mul(g[2][0], qx));
    acc = add(acc, mul(g[2][1], qy));
    g_q[3] = mul(ts, acc);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      g_q[k] = live ? add(g_q[k], mul(mul(p.q[k], 2.0f), g_qn2)) : 0.0f;

    // the means, through the view and clip rows
    const float(*Fm)[4] = cam.F;
    float g_m[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      g_m[k] = add(add(add(add(add(mul(V[0][k], g_tv[0]), mul(V[1][k], g_tv[1])),
                               mul(V[2][k], g_dep)), mul(Fm[0][k], g_hx)),
                       mul(Fm[1][k], g_hy)), mul(Fm[2][k], g_hw));

    // colour: SH at the unit view direction, clamped at 0
    float g_v[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (DEG >= 0) {
      float d[3], dn;
      view_dir(p, cam, d, dn);
      const float* sh = shs + (size_t)i * K * 3;
      float g_o[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        g_o[ch] = sh_eval<DEG>(sh, ch, d) >= 0.0f
                      ? cot(g_rgb, ld_rgb, ch, i) : 0.0f;
      float b[NC], db[NC][3];
      sh_basis<DEG>(d, b, db);
      float g_dir[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const float s_k = add(add(mul(g_o[0], sh[3 * k]),
                                  mul(g_o[1], sh[3 * k + 1])),
                              mul(g_o[2], sh[3 * k + 2]));
#pragma unroll
        for (int r = 0; r < 3; ++r)
          if (DB_HAS[k][r]) g_dir[r] = add(g_dir[r], mul(s_k, db[k][r]));
      }
      if (d_shs != nullptr) {
        float* gs = d_shs + (size_t)i * K * 3;
#pragma unroll
        for (int k = 0; k < NC; ++k)
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) gs[3 * k + ch] = mul(g_o[ch], b[k]);
      }
      const float dot = add(add(mul(g_dir[0], d[0]), mul(g_dir[1], d[1])),
                            mul(g_dir[2], d[2]));
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        g_v[r] = mul(dn, sub(g_dir[r], mul(d[r], dot)));
        g_m[r] = add(g_m[r], g_v[r]);
      }
    }

    if (d_means != nullptr)
#pragma unroll
      for (int k = 0; k < 3; ++k) d_means[3 * i + k] = g_m[k];
    if (d_scales != nullptr)
#pragma unroll
      for (int k = 0; k < 3; ++k) d_scales[3 * i + k] = g_s[k];
    if (d_quats != nullptr)
#pragma unroll
      for (int k = 0; k < 4; ++k) d_quats[4 * i + k] = g_q[k];

    if (partial != nullptr) {
      const float g_row[3] = {g_tv[0], g_tv[1], g_dep};
      const float g_clip[3] = {g_hx, g_hy, g_hw};
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          cg[4 * r + k] = gV[r][k] + g_row[r] * p.m[k];
          cg[12 + 4 * r + k] = g_clip[r] * p.m[k];
        }
        cg[4 * r + 3] = g_row[r];
        cg[12 + 4 * r + 3] = g_clip[r];
        cg[24 + r] = -g_v[r];
      }
    }
  }

  if (partial != nullptr) {
    // the block's partial: warps by shuffles, then the warps in order
    __shared__ float s_part[THREADS / 32][CAM_PARTIALS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < CAM_PARTIALS; ++k) {
      float v = cg[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) s_part[warp][k] = v;
    }
    __syncthreads();
    if (threadIdx.x < CAM_PARTIALS) {
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) v += s_part[w][threadIdx.x];
      partial[(size_t)blockIdx.x * CAM_PARTIALS + threadIdx.x] = v;
    }
  }
}

// Sums the blocks' partial rows in a fixed order: warp k sums column k,
// lane l the rows l, l + 32, ..., then five shuffle steps. Writes the whole
// of each gradient that is asked for (w2c row 3 and full_proj row 2 zero).
__global__ void preprocess_reduce_kernel(const float* __restrict__ partial,
                                         int rows, float* d_w2c,
                                         float* d_full_proj,
                                         float* d_campos) {
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  if (k >= CAM_PARTIALS) return;
  float v = 0.0f;
  for (int r = lane; r < rows; r += 32)
    v += partial[(size_t)r * CAM_PARTIALS + k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane != 0) return;
  if (k < 12) {
    if (d_w2c) d_w2c[k] = v;
    if (d_w2c && k < 4) d_w2c[12 + k] = 0.0f;
  } else if (k < 24) {
    const int e = k - 12, row = e / 4;
    if (d_full_proj) d_full_proj[(row == 2 ? 3 : row) * 4 + e % 4] = v;
    if (d_full_proj && e < 4) d_full_proj[8 + e] = 0.0f;
  } else if (d_campos) {
    d_campos[k - 24] = v;
  }
}

template <typename F>
int for_degree(int deg, F&& f) {
  switch (deg) {
    case -1: return f(std::integral_constant<int, -1>{});
    case 0: return f(std::integral_constant<int, 0>{});
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// means [n, 3], scales [n, 3], quats [n, 4], shs [n, K, 3] float32; deg 0-3
// (-1: colors [n, 3] given, shs unread); alive [n] bytes or null; opac [n];
// w2c, full_proj [4, 4], campos [3], fovx, fovy one float each, on the
// card. Writes mean2d [2, n], conic [3, n], depth [n], rgb [3, n],
// normal [3, n], radius [n] int32, visible [n] bytes, ext [2, n].
extern "C" int rodygs_preprocess_fwd(
    const float* means, const float* scales, const float* quats,
    const float* shs, int n, int K, int deg, const uint8_t* alive,
    const float* colors, const float* opac, const float* w2c,
    const float* full_proj, const float* campos, const float* fovx,
    const float* fovy, int W, int H, float smod, float* mean2d, float* conic,
    float* depth, float* rgb, float* normal, int* radius, uint8_t* visible,
    float* ext, cudaStream_t stream) {
  if (n <= 0 || (deg >= 0 && K < (deg + 1) * (deg + 1)) ||
      (deg < 0 && colors == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  return for_degree(deg, [&](auto d) {
    preprocess_fwd_kernel<decltype(d)::value>
        <<<blocks, THREADS, 0, stream>>>(
            means, scales, quats, shs, n, K, alive, colors, opac, w2c,
            full_proj, campos, fovx, fovy, W, H, smod, mean2d, conic, depth,
            rgb, normal, radius, visible, ext);
    return (int)cudaGetLastError();
  });
}

// The backward: the inputs as the forward took them (deg -1: no SH), the
// cotangents of mean2d, conic, rgb and normal as [R, n] rows of stride
// ld_* (null: zero), of depth [n]; the gradients d_means [n, 3],
// d_scales [n, 3], d_quats [n, 4], d_shs [n, K, 3] (null: not written)
// and, when partial is not null, one row of 27 camera terms a block of 256
// Gaussians for rodygs_preprocess_reduce.
extern "C" int rodygs_preprocess_bwd(
    const float* means, const float* scales, const float* quats,
    const float* shs, int n, int K, int deg, const uint8_t* alive,
    const float* w2c, const float* full_proj, const float* campos,
    const float* fovx, const float* fovy, int W, int H, float smod,
    const float* g_mean2d, int ld_mean2d, const float* g_conic, int ld_conic,
    const float* g_depth, const float* g_rgb, int ld_rgb,
    const float* g_normal, int ld_normal, float* d_means, float* d_scales,
    float* d_quats, float* d_shs, float* partial, cudaStream_t stream) {
  if (n <= 0 || (deg >= 0 && K < (deg + 1) * (deg + 1)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  return for_degree(deg, [&](auto d) {
    preprocess_bwd_kernel<decltype(d)::value>
        <<<blocks, THREADS, 0, stream>>>(
            means, scales, quats, shs, n, K, alive, w2c, full_proj, campos,
            fovx, fovy, W, H, smod, g_mean2d, ld_mean2d, g_conic, ld_conic,
            g_depth, g_rgb, ld_rgb, g_normal, ld_normal, d_means, d_scales,
            d_quats, d_shs, partial);
    return (int)cudaGetLastError();
  });
}

// partial [rows, 27] -> d_w2c [4, 4], d_full_proj [4, 4], d_campos [3]
// (each null: not written).
extern "C" int rodygs_preprocess_reduce(const float* partial, int rows,
                                        float* d_w2c, float* d_full_proj,
                                        float* d_campos,
                                        cudaStream_t stream) {
  if (rows < 0) return (int)cudaErrorInvalidValue;
  preprocess_reduce_kernel<<<1, 32 * CAM_PARTIALS, 0, stream>>>(
      partial, rows, d_w2c, d_full_proj, d_campos);
  return (int)cudaGetLastError();
}
