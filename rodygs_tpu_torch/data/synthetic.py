"""Synthetic dynamic scene in the RoDyGS on-disk dataset layout. The port's
counterpart of `scripts/make_synthetic_scene.py`, rendered by the port's
own `render()` (that script imports the JAX package).

Writes everything the training pipeline reads: train/test frames,
`{train,test}_transforms.json`, `depth_anything/*.npy`, `tam_mask/*.png`,
`mast3r_opt/exp0/{static,dynamic}/*.ply` and `global_params.pkl` (with
optionally perturbed MASt3R poses, `perturb_c2ws`). Frame i of F is at time
i/(F-1) on a small arc; the static set's cloud is written for every frame,
the dynamic set's at its position at that frame's time. The test split
repeats the train views unless `make_scene_views` is given `test_times`,
which renders test views at those times, on the arc between the train
cameras. Each view is rendered at the fov the readers derive from its
size (`camera_angle_x` 0.9 rad).

    python -m rodygs_tpu_torch.data.synthetic --out <dir> \\
        --n_static 200 --n_dyn 40 --frames 6 [--width 64 --height 48] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import pickle
import shutil
from pathlib import Path

import numpy as np
import torch

from ..ops.quaternion import quat_to_matrix
from ..ops.sh import rgb2sh
from ..ops.transforms import focal2fov, fov2focal
from ..render.camera import make_camera
from ..render.compact import profile_for_demand
from ..render.rasterize import render
from ..utils.platform import resolve_device
from ..utils.ply import write_ply

FOVX = 0.9


def _camera_at(t: float, fovy: float, device):
    ang = (t - 0.5) * 0.1
    return make_camera(
        np.array([np.cos(ang / 2), 0, np.sin(ang / 2), 0], np.float32),
        np.array([np.sin(ang) * 3.0, 0.0, 0.0], np.float32), FOVX, fovy,
        time=t, device=device)


def make_scene_views(n_static, n_dyn, n_frames, width, height, seed=5,
                     motion_amp=0.0, test_times=(), device=None):
    """Seeded static and dynamic Gaussians and their renders. Returns
    ((static points, colours), (dynamic colours, position at t), train
    views, test views); a view is (camera, [H, W, 3] image)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    sm = rng.uniform([-1.2, -0.9, 2.5], [1.2, 0.9, 4.5],
                     size=(n_static, 3)).astype(np.float32)
    ss = (0.12 * rng.uniform(0.6, 1.4, size=(n_static, 3))).astype(np.float32)
    so = rng.uniform(0.6, 0.95, size=(n_static,)).astype(np.float32)
    sc = rng.uniform(0.1, 0.9, size=(n_static, 3)).astype(np.float32)

    dm0 = rng.uniform([-0.8, -0.5, 2.8], [0.8, 0.5, 3.8],
                      size=(n_dyn, 3)).astype(np.float32)
    vel = rng.uniform(-0.4, 0.4, size=(n_dyn, 3)).astype(np.float32)
    # optional nonlinear motion: a sinusoid with random phase and 1-2 cycles
    # over the clip, anchored so that t = 0 stays at dm0
    phase = rng.uniform(0, 2 * np.pi, size=(n_dyn, 3)).astype(np.float32)
    freq = rng.integers(1, 3, size=(n_dyn, 1)).astype(np.float32)

    def dyn_pos(t):
        pos = dm0 + vel * t
        if motion_amp > 0:
            pos = pos + motion_amp * (
                np.sin(2 * np.pi * freq * t + phase) - np.sin(phase))
        return pos.astype(np.float32)
    ds = np.full((n_dyn, 3), 0.15, np.float32)
    do = np.full((n_dyn,), 0.9, np.float32)
    dc = rng.uniform(0.1, 0.9, size=(n_dyn, 3)).astype(np.float32)
    n = n_static + n_dyn
    quats = np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1))
    shs = np.zeros((n, 4, 3), np.float32)
    shs[:, 0] = rgb2sh(torch.from_numpy(np.concatenate([sc, dc]))).numpy()
    fixed = [torch.tensor(x, device=dev) for x in (
        shs, np.concatenate([so, do]), np.concatenate([ss, ds]), quats)]
    fovy = focal2fov(fov2focal(FOVX, width), height)
    profile = "lean"

    @torch.no_grad()
    def view(t):
        nonlocal profile
        cam = _camera_at(t, fovy, dev)
        means = torch.tensor(np.concatenate([sm, dyn_pos(t)]), device=dev)
        while True:
            out = render(means, *fixed, cam, 1, width, height,
                         fragment_profile=profile, include_normal=False)
            wider = (profile_for_demand(n, int(out["num_fragments"]), profile)
                     if int(out["dropped"]) else None)
            if wider is None:
                return cam, out["rendered_image"].cpu().numpy()
            profile = wider

    views = [view(i / max(n_frames - 1, 1)) for i in range(n_frames)]
    test_views = [view(float(t)) for t in test_times]
    return (sm, sc), (dc, dyn_pos), views, test_views


def perturb_c2ws(c2ws: np.ndarray, rot_deg: float, trans: float,
                 seed: int = 9) -> np.ndarray:
    """Perturb camera-to-world poses with random small rotations
    (axis-angle, `rot_deg` stddev) and translations (`trans` stddev per
    axis): the MASt3R training-init poses then differ from the exact GT,
    and training has to pull them back photometrically."""
    rng = np.random.default_rng(seed)
    out = c2ws.copy()
    for i in range(len(out)):
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        ang = np.deg2rad(rng.normal(0, rot_deg))
        k = np.array([[0, -axis[2], axis[1]],
                      [axis[2], 0, -axis[0]],
                      [-axis[1], axis[0], 0]], np.float32)
        r = (np.eye(3, dtype=np.float32) + np.sin(ang) * k
             + (1 - np.cos(ang)) * (k @ k))
        out[i, :3, :3] = r @ out[i, :3, :3]
        out[i, :3, 3] += rng.normal(0, trans, size=3).astype(np.float32)
    return out


def _c2w_of(cam) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = quat_to_matrix(cam.q_c2w.cpu()).numpy()
    m[:3, 3] = cam.t_c2w.cpu().numpy()
    return m


def write_scene(out, scene, width, height, pose_noise_rot_deg=0.0,
                pose_noise_trans=0.0) -> Path:
    from PIL import Image

    (sm, sc), (dc, dyn_pos), views, test_views = scene
    root = Path(out)
    if root.exists():
        shutil.rmtree(root)
    for d in ("train", "test", "depth_anything", "tam_mask"):
        (root / d).mkdir(parents=True)
    exp = root / "mast3r_opt" / "exp0"
    (exp / "static").mkdir(parents=True)
    (exp / "dynamic").mkdir()

    def frame_record(split, i, cam, img):
        name = f"rgb_{i:05d}.png"
        arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        Image.fromarray(arr).save(root / split / name)
        return {"file_path": f"{split}/{name}",
                "transform_matrix": _c2w_of(cam).tolist(),
                "time": float(cam.time)}

    frames = []
    for i, (cam, img) in enumerate(views):
        frames.append(frame_record("train", i, cam, img))
        np.save(root / "depth_anything" / f"rgb_{i:05d}.npy",
                np.linspace(1, 2, height)[:, None]
                .repeat(width, 1).astype(np.float32))
        mask = np.zeros((height, width), np.uint8)
        mask[:, width // 2:] = 255
        Image.fromarray(mask).save(root / "tam_mask" / f"{i:06d}.png")
        write_ply(exp / "static" / f"{i:05d}.ply", sm, colors=sc)
        write_ply(exp / "dynamic" / f"{i:05d}.ply",
                  dyn_pos(float(cam.time)), colors=dc)
    test_frames = [frame_record("test", i, cam, img)
                   for i, (cam, img) in enumerate(test_views or views)]

    fovx_deg = float(np.rad2deg(FOVX))
    for fname, ff in (("train_transforms.json", frames),
                      ("test_transforms.json", test_frames)):
        with open(root / fname, "w") as f:
            json.dump({"camera_angle_x": fovx_deg, "frames": ff}, f)
    c2ws = np.stack([_c2w_of(c) for c, _ in views])
    if pose_noise_rot_deg > 0 or pose_noise_trans > 0:
        c2ws = perturb_c2ws(c2ws, pose_noise_rot_deg, pose_noise_trans)
    with open(exp / "global_params.pkl", "wb") as f:
        pickle.dump({"focals": [float(fov2focal(FOVX, 512))],
                     "cam2worlds": c2ws}, f)
    return root


def main(argv=None):
    parser = argparse.ArgumentParser("rodygs_tpu_torch synthetic scene")
    parser.add_argument("--out", required=True)
    parser.add_argument("--n_static", type=int, default=200)
    parser.add_argument("--n_dyn", type=int, default=40)
    parser.add_argument("--frames", type=int, default=6)
    parser.add_argument("--width", type=int, default=64)
    parser.add_argument("--height", type=int, default=48)
    parser.add_argument("--pose_noise_rot_deg", type=float, default=0.0,
                        help="stddev of rotation noise on the MASt3R "
                             "(training-init) poses; GT stays exact")
    parser.add_argument("--pose_noise_trans", type=float, default=0.0,
                        help="stddev of translation noise on the MASt3R "
                             "(training-init) poses")
    parser.add_argument("--motion_amp", type=float, default=0.0,
                        help="amplitude of nonlinear (sinusoidal) dynamic "
                             "motion on top of the linear drift")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device of the renders (default cuda; "
                             "cpu only when asked for)")
    args = parser.parse_args(argv)
    scene = make_scene_views(args.n_static, args.n_dyn, args.frames,
                             args.width, args.height,
                             motion_amp=args.motion_amp, device=args.device)
    root = write_scene(args.out, scene, args.width, args.height,
                       args.pose_noise_rot_deg, args.pose_noise_trans)
    print(f"scene written to {root}")


if __name__ == "__main__":
    main()
