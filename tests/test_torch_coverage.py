"""Every module of the JAX package has its counterpart in the port: for each
`rodygs_tpu/<path>.py`, `rodygs_tpu_torch/<path>.py` exists and defines or
imports, at its top level, every public function and class the JAX module
defines at its top level. Every parameter name of such a function, and of
each public method of such a class (`__init__` and `__call__` included),
is a parameter of its counterpart: the port may add parameters, never
drop one a caller of the JAX package may pass. Parsed with `ast`, so
neither package is imported.

The exceptions, each with its reason, are in EXEMPT and SIGNATURE_EXEMPT.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = REPO / "rodygs_tpu", REPO / "rodygs_tpu_torch"

EXEMPT = {
    ("utils/platform.py", "respect_jax_platforms_env"):
        "the JAX_PLATFORMS variable selects JAX's backend; the port's entry "
        "points take --device instead",
    ("utils/profiling.py", "enable_persistent_compile_cache"):
        "JAX's compilation cache; the port compiles nothing per process but "
        "its CUDA kernels, which rodygs_tpu_torch/_build/ keeps across "
        "processes",
}
_SEEDS = ("the port draws from seeded torch.Generators: a JAX key or rng "
          "argument has no counterpart")
# (module, function or Class.method): {JAX parameter the port lacks: reason}
SIGNATURE_EXEMPT = {
    ("models/motion.py", "init_motion_params"): {"key": _SEEDS},
    ("train/densify.py", "densify_and_prune"): {"key": _SEEDS},
    ("train/trainer_dynamic.py", "DynTrainer.__init__"): {"rng": _SEEDS},
    ("train/trainer_dynamic.py", "DynTrainer.maybe_densify"): {"rng": _SEEDS},
    ("train/trainer_joint.py", "RoDyGSTrainer.train_iteration"):
        {"rng": _SEEDS},
    ("train/trainer_joint.py", "RoDyGSTrainer.save_resume"): {"key": _SEEDS},
    ("train/trainer_static.py", "ThreeDGSTrainer.train_iteration"):
        {"rng": _SEEDS},
    ("parallel/mesh.py", "make_mesh"):
        {"devices": "a mesh spans processes, not a list of devices: "
                    "`ranks=` takes the first ranks of the world"},
    ("parallel/sharded.py", "composite_axes"): {
        "n_gauss": "takes the mesh, which holds both axis sizes",
        "n_tile": "takes the mesh, which holds both axis sizes"},
    ("parallel/sharded.py", "make_sharded_densify"): {
        "cfg": "takes the trainer's local densify, which holds cfg",
        "spatial_lr_scale": "takes the trainer's local densify, which "
                            "holds the scale"},
    ("parallel/sharded.py", "make_sharded_dynamic_densify"): {
        "cfg": "takes the trainer's local densify, which holds cfg",
        "spatial_lr_scale": "takes the trainer's local densify, which "
                            "holds the scale"},
    ("parallel/sharded.py", "make_sharded_dynamic_step"): {
        "cfg": "takes the dynamic trainer, which holds cfg",
        "loss": "takes the dynamic trainer, which holds the loss"},
    ("render/tile_kernel.py", "rasterize_fwd_impl"):
        {"padded_records": "the CUDA kernel takes the records unpadded"},
    ("render/tile_kernel.py", "rasterize_bwd_impl"):
        {"padded_records": "the CUDA kernel takes the records unpadded"},
}
MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def public_definitions(tree: ast.Module) -> set:
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def top_level_names(tree: ast.Module) -> set:
    """Names a module binds at its top level: definitions, imports and
    assignments."""
    out = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in n.names)
        elif isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
    return out


def test_every_jax_module_is_listed():
    assert len(MODULES) > 40 and "render/rasterize.py" in MODULES


@pytest.mark.parametrize("module", MODULES)
def test_module_has_its_counterpart(module):
    port = PORT_PKG / module
    assert port.exists(), f"rodygs_tpu_torch/{module} is missing"
    want = public_definitions(ast.parse((JAX_PKG / module).read_text()))
    have = top_level_names(ast.parse(port.read_text()))
    missing = {name for name in want - have
               if (module, name) not in EXEMPT}
    assert not missing, f"rodygs_tpu_torch/{module} lacks {sorted(missing)}"
    for (mod, name), reason in EXEMPT.items():
        if mod == module:
            assert name in want and reason


def parameters(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]


def signatures(tree: ast.Module) -> dict:
    """{function or Class.method: parameter names} of a module's public
    top-level functions and the public methods of its public classes."""
    out = {}
    for n in tree.body:
        if getattr(n, "name", "_").startswith("_"):
            continue
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[n.name] = parameters(n)
        elif isinstance(n, ast.ClassDef):
            for m in n.body:
                if (isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and (not m.name.startswith("_")
                             or m.name in ("__init__", "__call__"))):
                    out[f"{n.name}.{m.name}"] = parameters(m)
    return out


def port_signatures(module: str) -> dict:
    """`signatures` of a port module, with the names it imports from
    another module of the port resolved there."""
    tree = ast.parse((PORT_PKG / module).read_text())
    out = signatures(tree)
    for n in tree.body:
        if not (isinstance(n, ast.ImportFrom) and n.level and n.module):
            continue
        base = Path(module).parent
        for _ in range(n.level - 1):
            base = base.parent
        other = base / (n.module.replace(".", "/") + ".py")
        if not (PORT_PKG / other).exists():
            continue
        theirs = port_signatures(str(other))
        for a in n.names:
            for key, names in theirs.items():
                head, dot, tail = key.partition(".")
                if head == a.name:
                    out.setdefault((a.asname or a.name) + dot + tail, names)
    return out


@pytest.mark.parametrize("module", MODULES)
def test_module_keeps_the_jax_parameters(module):
    want = signatures(ast.parse((JAX_PKG / module).read_text()))
    have = port_signatures(module)
    lacking = {}
    for name, params in want.items():
        if (module, name.split(".")[0]) in EXEMPT:
            continue
        exempt = SIGNATURE_EXEMPT.get((module, name), {})
        assert name in have, f"rodygs_tpu_torch/{module} lacks {name}"
        for p in exempt:    # every exemption still stands
            assert p in params and p not in have[name], (module, name, p)
        miss = [p for p in params if p not in have[name] and p not in exempt]
        if miss:
            lacking[name] = miss
    assert not lacking, (f"rodygs_tpu_torch/{module}: parameters of the JAX "
                         f"signature missing in the port {lacking}")
    for (mod, name), reasons in SIGNATURE_EXEMPT.items():
        if mod == module:
            assert name in want and all(reasons.values())
