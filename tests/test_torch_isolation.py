"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports ``jax`` or ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _sources():
    return sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_or_repro_imports():
    sources = _sources()
    assert len(sources) > 20 and (ROOT / "chip_smoke.py").exists()
    bad = {
        str(p.relative_to(ROOT)): sorted(set(_imported_roots(p)) & set(FORBIDDEN))
        for p in sources
    }
    assert not {k: v for k, v in bad.items() if v}


def test_every_module_imports_without_jax_or_repro():
    modules = sorted(
        ".".join(p.relative_to(PACKAGE.parent).with_suffix("").parts).removesuffix(".__init__")
        for p in PACKAGE.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in FORBIDDEN)
        + f"for m in {modules!r}:\n    importlib.import_module(m)\n"
        + "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= len(modules)


def test_fleet_and_mobility_stand_alone():
    """The city-scale fleet and the mobility layer are covered: their
    modules are among the sources checked above, and their entry points run
    on ``cuda`` unless given the CPU."""
    import inspect

    names = {str(p.relative_to(PACKAGE)) for p in _sources() if PACKAGE in p.parents}
    for module in ("fleet/__init__.py", "fleet/plane.py", "fleet/budget.py", "fleet/runtime.py",
                   "fleet/experiment.py", "mobility/__init__.py", "mobility/motion.py",
                   "mobility/coverage.py", "mobility/handover.py", "mobility/policy.py",
                   "mobility/runtime.py", "launch/mesh.py"):
        assert module in names, module
    from repro_torch.fleet import default_city_scenario
    from repro_torch.mobility import default_mobile_scenario, rollout

    for fn in (default_city_scenario, default_mobile_scenario, rollout):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
