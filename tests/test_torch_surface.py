"""The port's public surface against the JAX package's, on the CPU.

For every subpackage present in both, ``repro_torch``'s ``__all__`` covers
``repro``'s and every listed name resolves; for every module present in
both, ``repro``'s public top-level definitions (functions, classes and
assigned names, read with ``ast`` so that ``repro`` is not imported) are
attributes of the port's module.  What the port leaves out by design is
listed once, below, each with its reason, and the lists are held to the
trees (a listed absence that the port gained, or that ``repro`` lost, fails).
"""
import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.detection.batch  # noqa: F401  (first: repro's kernels import it back)
from repro.data.shapes import render_image as j_render_image
from repro.detection.boxes import cxcywh_to_xyxy as j_cxcywh_to_xyxy
from repro.detection.boxes import xyxy_to_cxcywh as j_xyxy_to_cxcywh

ROOT = Path(__file__).resolve().parents[1]
REPRO = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

_KERNEL = "the Pallas kernel; its hand-written CUDA lives in kernels/csrc"
_NO_INTERPRETER = ("no interpreter path: a CPU tensor takes the plain version, a CUDA tensor "
                   "the kernel (kernels/dispatch.py resolve_path)")
_PIPELINE = "the TPU pipeline's fused / lax choice; the port has the kernel and its plain version"
_PYTREE = "a typing alias for JAX pytrees; the port's trees are nested dicts (tree.Tree)"
_TPU_RATE = "a TPU v5e data-sheet rate; the port's rooflines take the H100's (launch/dryrun.py)"

#: repro modules the port has no counterpart of, and why
ABSENT_MODULES = {
    "kernels/iou_matrix/kernel.py": _KERNEL,
    "kernels/estimator_mlp/kernel.py": _KERNEL,
    "kernels/score_pipeline/kernel.py": _KERNEL,
    "kernels/flash_sdpa/kernel.py": _KERNEL,
    "kernels/wkv6/kernel.py": _KERNEL,
    "obs/jit_stats.py": "JAX retrace counters; obs/kernel_stats.py counts kernel launches",
}

#: (repro module, name) the port's counterpart leaves out, and why
ABSENT_NAMES = {
    ("obs/__init__.py", "jit_stats"): ABSENT_MODULES["obs/jit_stats.py"],
    ("kernels/dispatch.py", "resolve_interpret"): _NO_INTERPRETER,
    ("kernels/iou_matrix/__init__.py", "resolve_interpret"): _NO_INTERPRETER,
    ("kernels/iou_matrix/__init__.py", "resolve_path"):
        "a re-export of kernels.dispatch.resolve_path, which the port keeps there only",
    ("kernels/score_pipeline/__init__.py", "PIPELINE_PATHS"): _PIPELINE,
    ("kernels/score_pipeline/__init__.py", "resolve_pipeline_path"): _PIPELINE,
    ("kernels/score_pipeline/ops.py", "PIPELINE_PATHS"): _PIPELINE,
    ("kernels/score_pipeline/ops.py", "resolve_pipeline_path"): _PIPELINE,
    ("models/detector.py", "detector_init"):
        "the port's Detector is an nn.Module that draws its weights in its constructor",
    ("models/layers.py", "chunked_scan"):
        "XLA's chunked scan; the port's ssd_scan chunks itself and flash_sdpa never forms "
        "the (S, T) logits",
    ("launch/dryrun.py", "collective_bytes"):
        "reads XLA's lowered HLO; LocalCost and trace_step count the port's collectives",
    ("launch/input_specs.py", "S"): "jax.ShapeDtypeStruct; the port's specs are meta tensors",
    ("launch/mesh.py", "HBM_BW"): _TPU_RATE,
    ("launch/mesh.py", "ICI_BW"): _TPU_RATE,
    ("launch/mesh.py", "PEAK_FLOPS_BF16"): _TPU_RATE,
    ("launch/mesh.py", "FLEET_AXIS"):
        "the JAX fleet mesh's axis name; the port's FleetPlane takes a list of devices",
    ("train/adamw.py", "PyTree"): _PYTREE,
    ("train/checkpoint.py", "PyTree"): _PYTREE,
    ("models/detector.py", "PyTree"): _PYTREE,
    ("core/estimator.py", "PyTree"): _PYTREE,
    ("launch/steps.py", "PyTree"): _PYTREE,
}


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _public_defs(path: Path):
    """The public names a module defines at top level (not those it imports)."""
    names = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _dunder_all(path: Path):
    for node in _tree(path).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts
                    if not isinstance(e, ast.Starred)]
    return None


def _relpaths(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.py"))


def _module_name(rel: str) -> str:
    parts = Path(rel).with_suffix("").parts
    return ".".join(("repro_torch",) + parts).removesuffix(".__init__")


BOTH = [r for r in _relpaths(REPRO) if (PORT / r).exists()]
PACKAGES = [r for r in BOTH if r.endswith("__init__.py") and _dunder_all(REPRO / r) is not None]
MODULES = [r for r in BOTH if not r.endswith("__init__.py")]


def test_absent_modules_are_exactly_the_listed_ones():
    missing = {r for r in _relpaths(REPRO) if not (PORT / r).exists()}
    assert missing == set(ABSENT_MODULES)


def test_listed_absent_names_are_in_repro_and_not_in_the_port():
    for (rel, name), reason in ABSENT_NAMES.items():
        assert reason
        in_repro = name in _public_defs(REPRO / rel) or name in (_dunder_all(REPRO / rel) or [])
        assert in_repro, (rel, name)
        assert not hasattr(importlib.import_module(_module_name(rel)), name), (rel, name)


@pytest.mark.parametrize("rel", PACKAGES)
def test_subpackage_all_covers_repro(rel):
    port = importlib.import_module(_module_name(rel))
    want = {n for n in _dunder_all(REPRO / rel) if (rel, n) not in ABSENT_NAMES}
    assert want <= set(port.__all__), sorted(want - set(port.__all__))
    for name in port.__all__:
        assert getattr(port, name) is not None, name


@pytest.mark.parametrize("rel", MODULES)
def test_module_names_cover_repro(rel):
    port = importlib.import_module(_module_name(rel))
    want = {n for n in _public_defs(REPRO / rel) if (rel, n) not in ABSENT_NAMES}
    assert not {n for n in want if not hasattr(port, n)}


def test_detection_exports_resolve_to_their_submodules():
    """Each lazily exported name is its submodule's object, also after the
    submodule ``nms`` was imported (which binds the name on the package)."""
    import repro_torch.detection as det
    import repro_torch.detection.nms  # noqa: F401

    for name in det.__all__:
        owner = det._LAZY.get(name, "tide")
        assert getattr(det, name) is getattr(
            importlib.import_module(f"repro_torch.detection.{owner}"), name), name
    from repro_torch.detection import nms

    assert callable(nms) and nms.__module__ == "repro_torch.detection.nms"


def test_importing_detection_leaves_the_kernels_out():
    code = ("import sys\nimport repro_torch.detection as d\n"
            "assert 'match_batch' in d.__all__\n"
            "print(sorted(m for m in sys.modules if m.startswith('repro_torch.kernels')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]"]


@pytest.mark.parametrize("shape", [(4,), (9, 4), (2, 5, 4)])
@pytest.mark.parametrize("name", ["cxcywh_to_xyxy", "xyxy_to_cxcywh"])
def test_box_conversions_equal_repro(name, shape):
    from repro_torch.detection import boxes

    rng = np.random.default_rng(len(shape))
    xy = rng.uniform(0, 60, shape[:-1] + (2,))
    b = np.concatenate([xy, xy + rng.uniform(1, 20, shape[:-1] + (2,))], -1).astype(np.float32)
    want = np.asarray({"cxcywh_to_xyxy": j_cxcywh_to_xyxy,
                       "xyxy_to_cxcywh": j_xyxy_to_cxcywh}[name](b))
    got = getattr(boxes, name)(torch.from_numpy(b))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_conversions_round_trip():
    from repro_torch.detection import cxcywh_to_xyxy, xyxy_to_cxcywh

    b = torch.tensor([[1.0, 2.0, 5.0, 8.0], [0.0, 0.0, 0.5, 0.25]])
    torch.testing.assert_close(cxcywh_to_xyxy(xyxy_to_cxcywh(b)), b)


def test_render_image_exported_and_equal_repro():
    from repro_torch.data import __all__ as data_all
    from repro_torch.data import render_image

    assert "render_image" in data_all
    img, gt = render_image(np.random.default_rng(3))
    j_img, j_gt = j_render_image(np.random.default_rng(3))
    np.testing.assert_array_equal(img, j_img)
    np.testing.assert_array_equal(gt.boxes, j_gt.boxes)
    np.testing.assert_array_equal(gt.classes, j_gt.classes)
