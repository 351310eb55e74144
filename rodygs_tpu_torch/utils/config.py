"""Config system: YAML, `{target, params}` reflection and dotlist
overrides. Port of `rodygs_tpu/utils/config.py`.

The shipped YAMLs (`configs/train/*.yaml`, `configs/eval/*.yaml`) name the
reference's classes (`src.data.datamodule.GSDataModule`, ...);
`_TARGET_ALIASES` maps each of them onto this package's counterpart, so the
same files drive the port unchanged. A target that resolves into the JAX
package (`rodygs_tpu.*`) is refused: the port never imports it.
"""

from __future__ import annotations

import copy
import importlib
from typing import Any

import yaml

_ROOT = "rodygs_tpu_torch"
_JAX_ROOT = "rodygs_tpu"

# reference dotted path -> rodygs_tpu_torch dotted path
_TARGET_ALIASES = {
    "src.data.datamodule.GSDataModule": "data.datamodule.GSDataModule",
    "src.data.datamodule.DataReader": "data.datamodule.DataReader",
    "src.data.datamodule.LazyDataReader": "data.datamodule.LazyDataReader",
    "src.data.utils.FixedCamera": "data.datamodule.FixedCameraSpec",
    "src.data.dataloader.PermutationSingleDataLoader":
        "data.sampler.PermutationSampler",
    "src.data.dataloader.SequentialSingleDataLoader":
        "data.sampler.SequentialSampler",
    "src.data.asset_readers.GTCameraReader": "data.readers.GTCameraReader",
    "src.data.asset_readers.MASt3RCameraReader":
        "data.readers.MASt3RCameraReader",
    "src.data.asset_readers.MASt3R_CKPTCameraReader":
        "data.readers.MASt3R_CKPTCameraReader",
    "src.data.asset_readers.Test_MASt3RFovCameraReader":
        "data.readers.Test_MASt3RFovCameraReader",
    "src.data.asset_readers.DepthAnythingReader":
        "data.readers.DepthAnythingReader",
    "src.data.asset_readers.TAMMaskReader": "data.readers.TAMMaskReader",
    "src.data.asset_readers.MASt3RPCDReader": "data.readers.MASt3RPCDReader",
    "src.model.rodygs_static.StaticRoDyGS": "pipelines.build.StaticModelSpec",
    "src.model.rodygs_dynamic.DynRoDyGS": "pipelines.build.DynModelSpec",
    "src.trainer.rodygs.RoDyGSTrainer": "pipelines.build.JointTrainerSpec",
    "src.trainer.rodygs_static.ThreeDGSTrainer":
        "pipelines.build.StaticTrainerSpec",
    "src.trainer.rodygs_dynamic.DynTrainer": "pipelines.build.DynTrainerSpec",
    "src.trainer.optim.CameraQuatOptimizer": "pipelines.build.CameraOptSpec",
    "src.trainer.losses.MultiLoss": "pipelines.build.MultiLossSpec",
    "src.evaluator.eval.RoDyGSEvaluator":
        "evalsuite.evaluator.RoDyGSEvaluator",
}
_TARGET_ALIASES = {k: f"{_ROOT}.{v}" for k, v in _TARGET_ALIASES.items()}


def get_obj_from_str(string: str) -> Any:
    string = _TARGET_ALIASES.get(string, string)
    if string.partition(".")[0] == _JAX_ROOT:
        raise ValueError(
            f"target {string!r} lies in the JAX package; the port resolves "
            f"targets into {_ROOT} only")
    module, cls = string.rsplit(".", 1)
    return getattr(importlib.import_module(module), cls)


def is_instantiable(config: Any) -> bool:
    return isinstance(config, dict) and "target" in config


def instantiate_from_config(config: dict, **kwargs) -> Any:
    """`{target: dotted.path, params: {...}}` -> object. Extra kwargs override
    params (the reference's calling convention)."""
    if not is_instantiable(config):
        raise ValueError(f"not an instantiable config: {config!r}")
    params = dict(config.get("params") or {})
    params.update(kwargs)
    return get_obj_from_str(config["target"])(**params)


def load_yaml(path: str) -> dict:
    with open(path) as f:
        return yaml.safe_load(f)


def merge_configs(*configs: dict) -> dict:
    """Deep right-biased merge (OmegaConf.merge semantics for plain dicts)."""
    out: dict = {}
    for cfg in configs:
        out = _merge_two(out, cfg)
    return out


def _merge_two(a: dict, b: dict) -> dict:
    out = copy.deepcopy(a)
    for k, v in (b or {}).items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _merge_two(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def apply_dotlist(config: dict, dotlist: list[str]) -> dict:
    """Apply `a.b.c=value` CLI overrides (OmegaConf dotlist semantics)."""
    out = copy.deepcopy(config)
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        key, _, raw = item.partition("=")
        value = yaml.safe_load(raw)
        node = out
        parts = key.lstrip("-").split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise ValueError(f"boolean value expected, got {v!r}")
