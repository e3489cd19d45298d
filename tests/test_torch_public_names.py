"""Every public top-level name of every JAX module has a counterpart of
the same name in the port's module at the same path (read with ``ast``,
nothing imported): functions, classes and assignments, and in a package's
``__init__.py`` the names it re-exports from the package. Other imports
are not names of the module. ``ops/pallas/`` holds the TPU kernels, whose port is
the kernel wrappers under ``ops/`` and ``csrc/``; the port-only files
have no JAX counterpart to hold."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "efficientsam3_tpu", ROOT / "efficientsam3_tpu_torch"


def public_names(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif (path.name == "__init__.py" and isinstance(node, ast.ImportFrom)
              and (node.level or (node.module or "").startswith("efficientsam3_tpu"))):
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_")}


def test_every_jax_public_name_has_a_port_counterpart():
    missing, modules = {}, 0
    for jp in sorted(JAX.rglob("*.py")):
        rel = jp.relative_to(JAX)
        if rel.parts[:2] == ("ops", "pallas"):
            continue
        modules += 1
        pp = PORT / rel
        if not pp.exists():
            missing[str(rel)] = "no module"
            continue
        lacking = sorted(public_names(jp) - public_names(pp))
        if lacking:
            missing[str(rel)] = lacking
    assert modules > 80
    assert not missing, missing


def test_the_walk_sees_the_names_it_holds():
    """The walk reads definitions, assignments and re-exports, and skips
    private names and plain imports."""
    names = public_names(JAX / "ops" / "interpolate.py")
    assert {"resize", "resize_bicubic", "resize_nearest", "resize_bilinear"} <= names
    assert "jnp" not in names and "_separable_resize" not in names
    assert {"resize", "grid_sample", "roi_align"} <= public_names(JAX / "ops" / "__init__.py")
    assert "EFFICIENTVIT_OUT_CHANNELS" in public_names(JAX / "models" / "efficientvit.py")
