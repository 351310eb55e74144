"""Every module of the JAX package has its counterpart in the port: for each
`rodygs_tpu/<path>.py`, `rodygs_tpu_torch/<path>.py` exists and defines or
imports, at its top level, every public function and class the JAX module
defines at its top level. Parsed with `ast`, so neither package is
imported.

The exceptions, each with its reason, are in EXEMPT.
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
