"""Convert reference RoDyGS torch checkpoints into the checkpoint format
both packages read (v2, `utils/checkpoint.py`). Port of
`scripts/convert_reference_ckpt.py`.

A reference training run leaves `<modeldir>/train/{static_last.ckpt,
dynamic_last.ckpt, config.yaml}` (torch.save tuples of the reference's
`src/trainer/rodygs.py:186-196`). This converts that modeldir into one the
eval CLIs read, so a trained reference scene is evaluated (test-time pose
optimisation included) without retraining:

    python -m rodygs_tpu_torch.tools.convert_reference_ckpt \
        --modeldir /path/to/logs/group/name_777 --outdir /path/to/converted
    python -m rodygs_tpu_torch.pipelines.eval \
        -c configs/eval/eval_wo_align.yaml -d <scene_dir> \
        -m /path/to/converted

Mapping (schemas: the reference's `rodygs_static.py:321-347` /
`rodygs_dynamic.py:298-303`; ours `trainer_static.state_dict` /
`trainer_dynamic.state_dict`):
  * model params `_xyz/_features_dc/_features_rest/_scaling/_rotation/
    _opacity`: identical names; capacity = N with an all-true alive mask
    (optionally padded by --capacity_factor with dead slots for further
    densification headroom).
  * `_motion_coeff` [N, 1, B]: identical.
  * `_deform_network`: torch `nn.Sequential` state dict -> the batched
    tree: `timenet.{0,2,4}.weight.T -> timenet.w{0,1,2}`,
    `basis_xyz.{b}.basis.{0,2}.weight.T` stacked over b ->
    `heads.w{0,1} [B, ...]`.
  * camera `R_c2ws_quat/T_c2ws` -> `q_c2w/t_c2w` (same wxyz convention).
  * densify stats carried ([N,1] squeezed to [N]); torch Adam moments are
    NOT carried (converted checkpoints are for evaluation / re-init, not
    bit-exact optimizer resume).
  * dynamic `_timestep` (gaussian_to_time) -> store `time`; `time_ind`
    rebuilt as the index into the sorted unique times.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

import numpy as np

from ..utils.checkpoint import save_checkpoint


def _np(x):
    return (x.detach().cpu().numpy() if hasattr(x, "detach")
            else np.asarray(x))


def load_reference_ckpt(path):
    import torch

    payload = torch.load(path, map_location="cpu", weights_only=False)
    sd, iteration = payload
    return sd, int(iteration)


def convert_deform_network(net_sd) -> dict:
    """torch MLPBasisNetwork state dict -> the motion-param tree
    (`models/motion.py:init_motion_params` layout)."""
    timenet = {}
    for i, idx in enumerate((0, 2, 4)):
        timenet[f"w{i}"] = _np(net_sd[f"timenet.{idx}.weight"]).T.astype(np.float32)
        timenet[f"b{i}"] = _np(net_sd[f"timenet.{idx}.bias"]).astype(np.float32)
    w0s, b0s, w1s, b1s = [], [], [], []
    b = 0
    while f"basis_xyz.{b}.basis.0.weight" in net_sd:
        w0s.append(_np(net_sd[f"basis_xyz.{b}.basis.0.weight"]).T)
        b0s.append(_np(net_sd[f"basis_xyz.{b}.basis.0.bias"]))
        w1s.append(_np(net_sd[f"basis_xyz.{b}.basis.2.weight"]).T)
        b1s.append(_np(net_sd[f"basis_xyz.{b}.basis.2.bias"]))
        b += 1
    if not w0s:
        raise ValueError("no basis_xyz heads found in _deform_network")
    heads = {
        "w0": np.stack(w0s).astype(np.float32),
        "b0": np.stack(b0s).astype(np.float32),
        "w1": np.stack(w1s).astype(np.float32),
        "b1": np.stack(b1s).astype(np.float32),
    }
    return {"timenet": timenet, "heads": heads}


def _pad(arr: np.ndarray, cap: int, fill=0) -> np.ndarray:
    n = arr.shape[0]
    if cap <= n:
        return arr
    pad = np.full((cap - n,) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad])


def convert_model(model_sd, capacity_factor: float) -> dict:
    keys = ("_xyz", "_features_dc", "_features_rest", "_scaling",
            "_rotation", "_opacity")
    model = {k: _np(model_sd[k]).astype(np.float32) for k in keys}
    n = model["_xyz"].shape[0]
    cap = max(n, int(round(n * capacity_factor)))
    model = {k: _pad(v, cap) for k, v in model.items()}
    model["alive"] = _pad(np.ones(n, bool), cap, False)

    if "_timestep" in model_sd:
        time = _np(model_sd["_timestep"]).reshape(-1).astype(np.float32)
    else:
        time = np.ones(n, np.float32)
    uniq = np.sort(np.unique(time))
    time_ind = np.searchsorted(uniq, time).astype(np.int32)
    model["time"] = _pad(time, cap, 1.0)
    model["time_ind"] = _pad(time_ind, cap)
    return model


def convert_stats(optim_sd, cap: int) -> dict:
    def squeeze(x):
        return _np(x).reshape(-1).astype(np.float32)

    out = {}
    for ref_key, key in (("max_radii2D", "max_radii2D"),
                         ("xyz_gradient_accum", "xyz_gradient_accum"),
                         ("denom", "denom")):
        if ref_key in optim_sd:
            out[key] = _pad(squeeze(optim_sd[ref_key]), cap)
    return out


def convert_checkpoint(sd: dict, iteration: int,
                       capacity_factor: float = 1.0) -> dict:
    model = convert_model(sd["model"], capacity_factor)
    cap = model["_xyz"].shape[0]
    out = {
        "iteration": iteration,
        "active_sh_degree": int(sd["active_sh_degree"]),
        "model": model,
        "optim": convert_stats(sd.get("optim", {}), cap),
        "spatial_lr_scale": float(_np(sd.get("spatial_lr_scale", 1.0))),
    }
    if "_motion_coeff" in sd["model"]:
        coeff = _np(sd["model"]["_motion_coeff"]).astype(np.float32)
        if coeff.ndim == 2:
            coeff = coeff[:, None, :]
        out["model"]["_motion_coeff"] = _pad(coeff, cap)
    if "_deform_network" in sd["model"]:
        out["model"]["_deform_network"] = convert_deform_network(
            sd["model"]["_deform_network"])
    if "camera" in sd:
        cam = sd["camera"]
        out["camera"] = {
            "q_c2w": _np(cam["R_c2ws_quat"]).astype(np.float32),
            "t_c2w": _np(cam["T_c2ws"]).astype(np.float32),
        }
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m rodygs_tpu_torch.tools.convert_reference_ckpt",
        description="Reference RoDyGS checkpoints -> a modeldir the eval "
                    "CLIs read.")
    p.add_argument("--modeldir", type=str, default=None,
                   help="reference log dir containing train/*.ckpt")
    p.add_argument("--static", type=str, default=None,
                   help="explicit static_last.ckpt path")
    p.add_argument("--dynamic", type=str, default=None,
                   help="explicit dynamic_last.ckpt path")
    p.add_argument("--outdir", required=True,
                   help="output modeldir (train/ subdir is created)")
    p.add_argument("--capacity_factor", type=float, default=1.0,
                   help=">1 pads dead slots for densification headroom")
    p.add_argument("--inverse_motion", type=lambda s: s.lower() != "false",
                   default=True,
                   help="the dynamic model's inverse_motion flag (not "
                        "stored in reference checkpoints; default true "
                        "matches the shipped configs)")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    static_path = args.static or (args.modeldir and
                                  Path(args.modeldir, "train", "static_last.ckpt"))
    if not static_path:
        p.error("--modeldir or --static required")
    out_train = Path(args.outdir) / "train"
    out_train.mkdir(parents=True, exist_ok=True)

    sd, iteration = load_reference_ckpt(static_path)
    save_checkpoint(out_train / "static_last.ckpt",
                    convert_checkpoint(sd, iteration, args.capacity_factor),
                    iteration)
    print(f"static: {static_path} -> {out_train/'static_last.ckpt'} "
          f"(N={_np(sd['model']['_xyz']).shape[0]}, iter={iteration})")

    dynamic_path = args.dynamic or (args.modeldir and
                                    Path(args.modeldir, "train", "dynamic_last.ckpt"))
    if dynamic_path and Path(dynamic_path).is_file():
        sd, iteration = load_reference_ckpt(dynamic_path)
        converted = convert_checkpoint(sd, iteration, args.capacity_factor)
        converted["inverse_motion"] = args.inverse_motion
        save_checkpoint(out_train / "dynamic_last.ckpt", converted, iteration)
        print(f"dynamic: {dynamic_path} -> {out_train/'dynamic_last.ckpt'}")

    if args.modeldir:
        cfg = Path(args.modeldir, "train", "config.yaml")
        if cfg.is_file():
            shutil.copy(cfg, out_train / "config.yaml")
            print(f"config: {cfg} -> {out_train/'config.yaml'}")


if __name__ == "__main__":
    main()
