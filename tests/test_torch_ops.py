"""Parity of the PyTorch port's geometry, image and preprocess ops with the
JAX package on the CPU (numpy-seeded inputs through both), and the port's
import isolation from JAX."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodygs_tpu.ops import covariance as jcov
from rodygs_tpu.ops import image as jimage
from rodygs_tpu.ops import knn as jknn
from rodygs_tpu.ops import quaternion as jq
from rodygs_tpu.ops import schedules as jsched
from rodygs_tpu.ops import sh as jsh
from rodygs_tpu.ops import transforms as jtf
from rodygs_tpu.render import camera as jcamera
from rodygs_tpu.render.preprocess import preprocess as jpreprocess
from rodygs_tpu_torch.ops import covariance as tcov
from rodygs_tpu_torch.ops import image as timage
from rodygs_tpu_torch.ops import knn as tknn
from rodygs_tpu_torch.ops import quaternion as tq
from rodygs_tpu_torch.ops import schedules as tsched
from rodygs_tpu_torch.ops import sh as tsh
from rodygs_tpu_torch.ops import transforms as ttf
from rodygs_tpu_torch.render import camera as tcamera
from rodygs_tpu_torch.render.preprocess import preprocess as tpreprocess

from test_render import H, W, make_scene

RNG = np.random.default_rng(0)
QUATS = RNG.normal(size=(64, 4)).astype(np.float32)
VECS = RNG.normal(size=(64, 3)).astype(np.float32)
GRAD_TOL = 5e-4


def T(x):
    return torch.tensor(np.array(x))


def close(a, b, atol=1e-6, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(b, np.float64),
                               np.asarray(a, np.float64), atol=atol, rtol=rtol)


def assert_scaled(a, b, name=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(a).max() + 1e-8
    np.testing.assert_allclose(b / scale, a / scale, atol=GRAD_TOL, err_msg=name)


def _rotmats():
    return np.asarray(jq.quat_to_matrix(jq.quat_normalize(QUATS)))


@pytest.mark.parametrize("name,args", [
    ("quat_normalize", lambda: (QUATS,)),
    ("quat_to_matrix", lambda: (QUATS,)),
    ("matrix_to_quat", lambda: (_rotmats(),)),
    ("quat_multiply", lambda: (QUATS, QUATS[::-1].copy())),
])
def test_quaternion_ops(name, args):
    a = args()
    close(getattr(jq, name)(*[jnp.asarray(x) for x in a]),
          getattr(tq, name)(*[T(x) for x in a]).numpy())


def test_transforms():
    q, t = QUATS[0], VECS[0]
    close(jtf.view_from_c2w_quat(jnp.asarray(q), jnp.asarray(t)),
          ttf.view_from_c2w_quat(T(q), T(t)).numpy())
    close(jtf.projection_matrix(0.01, 100.0, 0.9, 0.7),
          ttf.projection_matrix(0.01, 100.0, 0.9, 0.7).numpy())
    m = np.asarray(jtf.view_from_c2w_quat(jnp.asarray(q), jnp.asarray(t)))
    close(jtf.transform_points(jnp.asarray(VECS), jnp.asarray(m)),
          ttf.transform_points(T(VECS), T(m)).numpy(), atol=1e-5)
    assert ttf.fov2focal(0.9, 512) == pytest.approx(float(jtf.fov2focal(0.9, 512)))
    assert ttf.focal2fov(500.0, 512) == pytest.approx(float(jtf.focal2fov(500.0, 512)))


def test_covariance():
    s = np.exp(VECS).astype(np.float32)
    jc = jcov.build_covariance(jnp.asarray(s), jnp.asarray(QUATS), 0.7)
    tc = tcov.build_covariance(T(s), T(QUATS), 0.7)
    close(jc, tc.numpy(), atol=1e-5)
    close(jcov.strip_symmetric(jc), tcov.strip_symmetric(tc).numpy(), atol=1e-5)
    close(jcov.unstrip_symmetric(jcov.strip_symmetric(jc)),
          tcov.unstrip_symmetric(tcov.strip_symmetric(tc)).numpy(), atol=1e-5)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh(deg):
    sh = RNG.normal(size=(64, 25, 3)).astype(np.float32)
    dirs = VECS / np.linalg.norm(VECS, axis=1, keepdims=True)
    close(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)),
          tsh.eval_sh(deg, T(sh), T(dirs)).numpy(), atol=1e-5)
    close(jsh.sh_to_rgb_clamped(deg, jnp.asarray(sh), jnp.asarray(dirs)),
          tsh.sh_to_rgb_clamped(deg, T(sh), T(dirs)).numpy(), atol=1e-5)


def test_image_losses_and_grads():
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    close(jimage.l1_loss(jnp.asarray(a), jnp.asarray(b)),
          timage.l1_loss(T(a), T(b)).item())
    close(jimage.ssim(jnp.asarray(a), jnp.asarray(b)),
          timage.ssim(T(a), T(b)).item(), atol=1e-6)
    close(jimage.ssim(jnp.asarray(a[..., 0]), jnp.asarray(b[..., 0])),
          timage.ssim(T(a[..., 0]), T(b[..., 0])).item(), atol=1e-6)
    gj = jax.grad(lambda x: 0.8 * jimage.l1_loss(x, jnp.asarray(b))
                  + 0.2 * (1 - jimage.ssim(x, jnp.asarray(b))))(jnp.asarray(a))
    x = T(a).requires_grad_(True)
    (0.8 * timage.l1_loss(x, T(b)) + 0.2 * (1 - timage.ssim(x, T(b)))).backward()
    assert_scaled(gj, x.grad.numpy())


def test_mean_knn_sqdist():
    pts = np.random.default_rng(2).uniform(-1, 1, (300, 3)).astype(np.float32)
    close(jknn.mean_knn_sqdist(jnp.asarray(pts), k=3),
          tknn.mean_knn_sqdist(T(pts), k=3, block_size=128).numpy(),
          atol=1e-6, rtol=1e-4)


@pytest.mark.parametrize("step", [0.0, 1.0, 37.0, 999.0, 25000.0])
def test_schedules(step):
    close(jsched.expon_lr(step, 1.6e-4 * 4, 1.6e-6 * 4, lr_delay_mult=0.01,
                          max_steps=20000),
          tsched.expon_lr(step, 1.6e-4 * 4, 1.6e-6 * 4, lr_delay_mult=0.01,
                          max_steps=20000).item(), atol=0, rtol=1e-6)
    close(jsched.expon_lr(step, 1e-2, 1e-4, lr_delay_steps=100,
                          lr_delay_mult=0.1, max_steps=5000),
          tsched.expon_lr(step, 1e-2, 1e-4, lr_delay_steps=100,
                          lr_delay_mult=0.1, max_steps=5000).item(),
          atol=0, rtol=1e-6)
    for warm in (0, 50):
        close(jsched.warmup_cosine_lr(step, 1e-5, warm, 20000),
              tsched.warmup_cosine_lr(step, 1e-5, warm, 20000).item(),
              atol=1e-12, rtol=1e-6)


def test_camera_from_w2c():
    R = _rotmats()[3]
    jc = jcamera.camera_from_w2c(R, VECS[3], 0.9, 0.7, 0.25)
    tc = tcamera.camera_from_w2c(R, VECS[3], 0.9, 0.7, 0.25, device="cpu")
    for a, b in zip(jc, tc):
        close(a, b.numpy(), atol=1e-6)
    close(jcamera.world_view_transform(jc),
          tcamera.world_view_transform(tc).numpy(), atol=1e-5)


def _tcam(cam, grad=False):
    return tcamera.Camera(T(cam.q_c2w).requires_grad_(grad),
                          T(cam.t_c2w).requires_grad_(grad),
                          T(cam.fovx), T(cam.fovy), T(cam.time))


@pytest.mark.parametrize("opts", [
    {}, {"alive": True}, {"colors_precomp": True}, {"pose_grad_only": True}])
def test_preprocess_forward(opts):
    means, scales, quats, opac, shs, cam = make_scene(n=200, sh_extra=True)
    n = means.shape[0]
    kw_j, kw_t = {}, {}
    if "alive" in opts:
        alive = np.arange(n) % 3 != 0
        quats = jnp.where(jnp.asarray(alive)[:, None], quats, 0.0)
        kw_j["alive"], kw_t["alive"] = jnp.asarray(alive), T(alive)
    if "colors_precomp" in opts:
        cols = np.random.default_rng(4).uniform(0, 1, (n, 3)).astype(np.float32)
        kw_j["colors_precomp"], kw_t["colors_precomp"] = jnp.asarray(cols), T(cols)
    if "pose_grad_only" in opts:
        kw_j["pose_grad_only"] = kw_t["pose_grad_only"] = True
    js = jpreprocess(means, scales, quats, opac, shs, 3, cam, W, H, 0.9, **kw_j)
    ts = tpreprocess(T(means), T(scales), T(quats), T(opac), T(shs), 3,
                     _tcam(cam), W, H, 0.9, **kw_t)
    for name, a, b in zip(js._fields, js, ts):
        b = b.detach().numpy()
        if a.dtype in (jnp.bool_, jnp.int32):
            np.testing.assert_array_equal(b, np.asarray(a), err_msg=name)
        else:
            close(a, b, atol=1e-4, rtol=1e-5)


def test_preprocess_grads_including_pose():
    means, scales, quats, opac, shs, cam = make_scene(n=150, sh_extra=True)
    n = means.shape[0]
    w = np.random.default_rng(6).normal(size=(13, n)).astype(np.float32)

    def reduce(s, lib):
        rows = lib.concatenate if lib is jnp else torch.cat
        mat = rows([s.mean2d, s.conic, s.depth[None], s.rgb,
                    s.opacity[None], s.normal], 0)
        return (mat * (jnp.asarray(w) if lib is jnp else T(w))).sum()

    def jloss(means, scales, quats, opac, shs, cam):
        return reduce(jpreprocess(means, scales, quats, opac, shs, 3, cam,
                                  W, H), jnp)

    gj = jax.grad(jloss, argnums=tuple(range(6)))(
        means, scales, quats, opac, shs, cam)
    leaves = [T(x).requires_grad_(True) for x in (means, scales, quats, opac,
                                                  shs)]
    tcam = _tcam(cam, grad=True)
    reduce(tpreprocess(*leaves, 3, tcam, W, H), torch).backward()
    for name, a, b in zip(["means", "scales", "quats", "opac", "shs"], gj,
                          leaves):
        assert_scaled(a, b.grad.numpy(), name)
    assert_scaled(gj[5].q_c2w, tcam.q_c2w.grad.numpy(), "q_c2w")
    assert_scaled(gj[5].t_c2w, tcam.t_c2w.grad.numpy(), "t_c2w")
    assert np.abs(tcam.q_c2w.grad.numpy()).max() > 0


def test_port_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import rodygs_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'rodygs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'rodygs_tpu' or m.startswith('rodygs_tpu.')]\n"
        "print(len(bad))\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
