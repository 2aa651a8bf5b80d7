"""The port's sharding rules against the JAX package's, exactly: for every
architecture and six mesh shapes (the TPU pod's 16 x 16 and 2 x 16 x 16,
the port's DGX 32 x 8 and 2 x 32 x 8, and the small 1 x 4 and 2 x 2 of the
four-process tests), the spec of every parameter (``tp`` and ``fsdp``), of
the optimizer state, of the batch and of the decode cache (all four cache
modes) equals ``repro``'s ``PartitionSpec`` element for element.  ``repro``
takes ``jax.sharding.AbstractMesh``es (no devices); the port takes
``MeshShape``s of the same names and sizes.  Also the logical mapping, the
divisibility fallback, the placements of a spec, ``constrain`` with no mesh
bound, and the production mesh's shape on a small world."""
import functools

import pytest
import torch
from jax.sharding import AbstractMesh

import _torch_parity  # noqa: F401  (first: it imports repro.detection before repro's kernels)
from repro.launch import input_specs as j_specs
from repro.launch import mesh as j_mesh
from repro.launch import sharding as jsh
from repro.launch.steps import abstract_opt_state as j_abstract_opt_state
from repro.models import lm as jlm

from repro_torch.configs import ARCH_IDS
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.launch.input_specs import SHAPES, input_specs
from repro_torch.launch.meshctx import constrain, named_sharding
from repro_torch.launch.steps import abstract_opt_state
from repro_torch.models import lm as tlm

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "32x8": ((32, 8), ("data", "model")),
    "2x32x8": ((2, 32, 8), ("pod", "data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
}
CASES = [(a, m) for a in ARCH_IDS for m in MESHES]


def meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), tmesh.MeshShape(shape, axes), len(shape) == 3


def jax_specs(tree):
    """path -> tuple(PartitionSpec) of a pytree of NamedShardings."""
    import jax

    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jsh._path_str(p): tuple(s.spec) for p, s in flat}


def port_specs(tree):
    return {tsh._path_str(p): s.spec for p, s in tsh._flatten(tree)}


def same(jtree, ttree):
    j, t = jax_specs(jtree), port_specs(ttree)
    assert set(j) == set(t)
    diff = {k: (j[k], t[k]) for k in j if j[k] != t[k]}
    assert not diff, diff
    return len(j)


@functools.lru_cache(maxsize=None)
def abstract(arch):
    jcfg, _ = j_specs.input_specs(arch, "train_4k")
    tcfg, _ = input_specs(arch, "train_4k")
    return jlm.abstract_params(jcfg), tlm.abstract_params(tcfg)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_rules_equal_repro(arch, mesh):
    jm, tm, multi = meshes(mesh)
    jmap, tmap = j_mesh.logical_axes(multi_pod=multi), tmesh.logical_axes(multi_pod=multi)
    assert tmap == jmap
    jp, tp = abstract(arch)
    n = 0
    for mode in ("tp", "fsdp"):
        n += same(jsh.param_shardings(jp, jm, jmap, mode=mode),
                  tsh.param_shardings(tp, tm, tmap, mode=mode))
        n += same(jsh.param_shardings(j_abstract_opt_state(jp), jm, jmap, mode=mode),
                  tsh.param_shardings(abstract_opt_state(tp), tm, tmap, mode=mode))
    for shape in SHAPES:
        _, js = j_specs.input_specs(arch, shape)
        _, ts = input_specs(arch, shape)
        if js["kind"] == "decode":
            for mode in tsh.CACHE_MODES:
                n += same(jsh.cache_shardings(js["cache"], jm, jmap, mode=mode),
                          tsh.cache_shardings(ts["cache"], tm, tmap, mode=mode))
        else:
            n += same(jsh.batch_shardings(js["batch"], jm, jmap),
                      tsh.batch_shardings(ts["batch"], tm, tmap))
    assert n > 0


def test_rule_tables_are_repro_s():
    assert tsh.PARAM_RULES == jsh.PARAM_RULES
    assert tsh.CACHE_MODES == jsh.CACHE_MODES


def test_resolve_replicates_what_does_not_divide():
    """4 KV heads x 128 over 16 divides (a quarter of a head a device), 3
    over 16 does not; leading stacked dims stay unsharded."""
    for shape, axes in MESHES.values():
        jm, tm = AbstractMesh(shape, axes), tmesh.MeshShape(shape, axes)
        mapping = j_mesh.logical_axes(multi_pod=len(shape) == 3)
        for arr, logical in (((28, 4096, 512), (None, "model")), ((28, 4096, 384), (None, "model")),
                             ((6, 1000), ("batch", "model")), ((64, 7), ("expert", None)),
                             ((5,), ("batch",))):
            assert tsh._resolve(logical, mapping, arr, tm) == tuple(
                jsh._resolve(logical, mapping, arr, jm))
    tm = tmesh.MeshShape((32, 8), ("data", "model"))
    mapping = tmesh.logical_axes()
    assert tsh._resolve((None, "model"), mapping, (28, 3584, 512), tm) == (None, None, "model")
    assert tsh._resolve((None, "model"), mapping, (3584, 500), tm) == (None, None)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    tm = tmesh.MeshShape((2, 32, 8), ("pod", "data", "model"))
    assert tsh.spec_placements(tm, (("pod", "data"), None, "model")) == (Shard(0), Shard(0), Shard(2))
    assert tsh.spec_placements(tm, (None, "model")) == (Replicate(), Replicate(), Shard(1))
    assert tsh.replicated(tm).placements() == (Replicate(),) * 3
    with pytest.raises(ValueError):
        tsh.spec_placements(tm, ("model", "model"))


def test_constrain_is_identity_without_a_mesh():
    x = torch.ones(4, 4)
    assert constrain(x, "batch", None) is x
    assert named_sharding("batch", None) is None


@pytest.mark.parametrize("world", [1, 4, 255])
def test_production_mesh_degrades_on_a_small_world(world):
    assert tmesh.production_shape(world=world) == ((world, 1), ("data", "model"))
    assert tmesh.production_shape(multi_pod=True, world=world) == (
        (1, world, 1), ("pod", "data", "model"))
    assert tmesh.production_shape(world=256) == ((32, 8), ("data", "model"))
    assert tmesh.production_shape(multi_pod=True, world=512) == ((2, 32, 8), ("pod", "data", "model"))
