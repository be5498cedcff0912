"""The port's sharding metadata against the reference's: the logical
specs of every configuration's parameters (``Model.specs``), decode
cache (``Model.cache_specs``), inputs (``batch_partition_specs``) and
optimizer state (``state_specs``), and ``parallel.sharding``'s rules
and resolution, as tuples of axis names; the production meshes and the
ambient mesh."""
import math

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as RefP

from repro import configs as ref_configs
from repro.launch import mesh as ref_mesh
from repro.models import api as ref_api
from repro.models import rwkv as ref_rwkv
from repro.models import ssm as ref_ssm
from repro.models import layers as ref_layers
from repro.models.config import LM_SHAPES as REF_CELLS
from repro.parallel import sharding as ref_sh
from repro.train import optimizer as ref_opt
from repro_torch import configs
from repro_torch.launch import mesh
from repro_torch.models import api, layers, param, rwkv, ssm
from repro_torch.models.config import shape_cell
from repro_torch.parallel import data_parallel as dp
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.collectives import MetaMesh
from repro_torch.train import optimizer

CASES = [(arch, smoke) for arch in ref_configs.ARCH_IDS
         for smoke in (False, True)]
IDS = [f"{a}-{'smoke' if s else 'full'}" for a, s in CASES]


def _configs(arch, smoke):
    if smoke:
        return ref_configs.smoke_config(arch), configs.smoke_config(arch)
    return ref_configs.get_config(arch), configs.get_config(arch)


def _ref_leaves(tree):
    """(path, entries) of a reference spec tree, in jax's leaf order."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefP))[0]
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in leaves]


def _port_leaves(tree):
    leaves, _ = param.tree_flatten(tree)
    assert all(isinstance(s, sh.PartitionSpec) for s in leaves)
    return [tuple(s) for s in leaves]


def _same(ref_tree, port_tree):
    want = _ref_leaves(ref_tree)
    got = _port_leaves(port_tree)
    assert got == [s for _, s in want], [
        (p, s, g) for (p, s), g in zip(want, got) if s != g][:3]
    # the same tree: the port's structure holds the reference's keys
    assert repr(param.tree_flatten(port_tree)[1].skeleton) == repr(
        param.tree_flatten(jax.tree.map(
            lambda s: None, ref_tree,
            is_leaf=lambda x: isinstance(x, RefP)))[1].skeleton)


@pytest.mark.parametrize("arch,smoke", CASES, ids=IDS)
def test_model_specs_equal_reference(arch, smoke):
    ref_cfg, cfg = _configs(arch, smoke)
    _same(ref_api.Model(ref_cfg).specs(), api.Model(cfg, device="meta").specs())


@pytest.mark.parametrize("arch,smoke", CASES, ids=IDS)
def test_cache_specs_equal_reference(arch, smoke):
    ref_cfg, cfg = _configs(arch, smoke)
    _same(ref_api.Model(ref_cfg).cache_specs(),
          api.Model(cfg, device="meta").cache_specs())


@pytest.mark.parametrize("arch,smoke", CASES, ids=IDS)
@pytest.mark.parametrize("kind", ["adamw", "sgdm"])
def test_state_specs_equal_reference(arch, smoke, kind):
    ref_cfg, cfg = _configs(arch, smoke)
    want = ref_opt.state_specs(ref_opt.OptConfig(kind=kind),
                               ref_api.Model(ref_cfg).specs())
    got = optimizer.state_specs(optimizer.OptConfig(kind=kind),
                                api.Model(cfg, device="meta").specs())
    assert isinstance(got, optimizer.OptState)
    if kind == "adamw":
        _same(tuple(want), tuple(got))
        return
    # sgdm's unused second moment is replicated.  The reference's tree of
    # it is a pytree prefix (its ``is_leaf`` takes anything with an
    # ``index``, so each list of the parameter tree is one P()), which
    # replicates the same leaves as the port's P() on every leaf.
    _same(want.mu, got.mu)
    assert tuple(want.step) == tuple(got.step) == ()
    assert all(s == () for s in _port_leaves(got.nu))
    assert all(s == () for _, s in _ref_leaves(want.nu))
    assert param.tree_flatten(got.nu)[1].num_leaves == \
        param.tree_flatten(got.mu)[1].num_leaves


@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
@pytest.mark.parametrize("cell", [c.name for c in REF_CELLS])
def test_batch_partition_specs_equal_reference(arch, cell):
    ref_cfg, cfg = _configs(arch, False)
    want = ref_api.batch_partition_specs(ref_cfg, shape_cell(cell))
    got = api.batch_partition_specs(cfg, shape_cell(cell))
    assert {k: tuple(v) for k, v in got.items()} == \
        {k: tuple(v) for k, v in want.items()}
    assert set(got) == set(api.input_specs(cfg, shape_cell(cell)))


@pytest.mark.parametrize("arch,smoke", CASES, ids=IDS)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_resolved_specs_equal_reference(arch, smoke, multi_pod):
    ref_cfg, cfg = _configs(arch, smoke)
    rules = sh.MULTI_POD_RULES if multi_pod else sh.SINGLE_POD_RULES
    ref_rules = ref_sh.MULTI_POD_RULES if multi_pod else \
        ref_sh.SINGLE_POD_RULES
    _same(ref_sh.resolve_tree(ref_api.Model(ref_cfg).specs(), ref_rules),
          sh.resolve_tree(api.Model(cfg, device="meta").specs(), rules))


def test_block_cache_specs_equal_reference():
    assert {k: tuple(v) for k, v in rwkv.rwkv_cache_specs().items()} == \
        {k: tuple(v) for k, v in ref_rwkv.rwkv_cache_specs().items()}
    assert {k: tuple(v) for k, v in ssm.mamba_cache_specs().items()} == \
        {k: tuple(v) for k, v in ref_ssm.mamba_cache_specs().items()}
    for windowed in (False, True):
        assert {k: tuple(v) for k, v in layers.cache_specs(windowed).items()
                } == {k: tuple(v) for k, v in
                      ref_layers.cache_specs(windowed).items()}


def test_rules_equal_reference():
    assert sh.SINGLE_POD_RULES == ref_sh.SINGLE_POD_RULES
    assert sh.MULTI_POD_RULES == ref_sh.MULTI_POD_RULES
    for multi_pod in (False, True):
        shape, axes = mesh.production_shape(multi_pod)
        assert (shape, axes) == ref_mesh.production_shape(multi_pod)
        logical = mesh.make_production_mesh(multi_pod=multi_pod)
        assert tuple(logical.shape.values()) == shape
        assert logical.axis_names == axes
        assert logical.devices.reshape(-1).tolist() == list(
            range(logical.size))
        fake = type("M", (), {"axis_names": axes})()
        assert sh.rules_for_mesh(logical) == ref_sh.rules_for_mesh(fake)
        assert sh.rules_for_mesh(MetaMesh(shape, axes)) == \
            ref_sh.rules_for_mesh(fake)
        over = {"batch": None}
        assert sh.rules_for_mesh(logical, over) == \
            ref_sh.rules_for_mesh(fake, over)


SPECS = [(), (None,), ("fsdp", "tp"), ("tp", "fsdp"), (None, "fsdp", "tp"),
         ("batch", "seq", None, None), ("ep", None, "fsdp"),
         (("batch", "fsdp"), None), (("tp", "nope"),), ("nope",),
         (("batch", "ep"), "seq")]


@pytest.mark.parametrize("spec", SPECS, ids=str)
@pytest.mark.parametrize("rules", ["single", "multi", "no-batch"])
def test_resolve_spec_equals_reference(spec, rules):
    pick = {"single": (sh.SINGLE_POD_RULES, ref_sh.SINGLE_POD_RULES),
            "multi": (sh.MULTI_POD_RULES, ref_sh.MULTI_POD_RULES),
            "no-batch": (dict(sh.MULTI_POD_RULES, batch=None),
                         dict(ref_sh.MULTI_POD_RULES, batch=None))}
    port_rules, ref_rules = pick[rules]
    got = sh.resolve_spec(sh.PartitionSpec(*spec), port_rules)
    want = ref_sh.resolve_spec(RefP(*spec), ref_rules)
    assert tuple(got) == tuple(want)
    assert got == tuple(want) and got == sh.PartitionSpec(*tuple(want))
    with sh.use_rules(port_rules), ref_sh.use_rules(ref_rules):
        assert tuple(sh.resolve_spec(sh.PartitionSpec(*spec))) == \
            tuple(ref_sh.resolve_spec(RefP(*spec)))


@pytest.mark.parametrize("spec", SPECS[:7], ids=str)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_named_sharding_resolves_as_the_reference(spec, multi_pod):
    """The port's ``named_sharding`` on the production mesh of logical ids
    against the reference's on a one-device jax mesh of the same axes
    (the rules read only the axis names), on the specs the declarations
    use (the reference's ``NamedSharding`` refuses a spec that names an
    axis the mesh lacks, or one axis twice)."""
    shape, axes = mesh.production_shape(multi_pod)
    ref_mesh_ = jax.sharding.Mesh(
        np.asarray(jax.devices()[:1]).reshape((1,) * len(axes)), axes)
    got = sh.named_sharding(mesh.make_production_mesh(multi_pod=multi_pod),
                            sh.PartitionSpec(*spec))
    want = ref_sh.named_sharding(ref_mesh_, RefP(*spec))
    assert tuple(got.spec) == tuple(want.spec)
    over = dict(sh.rules_for_mesh(MetaMesh(shape, axes)), tp=None)
    assert tuple(sh.named_sharding(MetaMesh(shape, axes), sh.PartitionSpec(
        *spec), over).spec) == tuple(ref_sh.named_sharding(
            ref_mesh_, RefP(*spec), over).spec)


def test_use_rules_nests_and_restores():
    assert sh.current_rules() == ref_sh.current_rules() == \
        sh.SINGLE_POD_RULES
    with sh.use_rules(sh.MULTI_POD_RULES):
        assert sh.current_rules() is sh.MULTI_POD_RULES
        with sh.use_rules({"batch": None}):
            assert sh.current_rules() == {"batch": None}
        assert sh.current_rules() is sh.MULTI_POD_RULES
    assert sh.current_rules() == sh.SINGLE_POD_RULES


def test_stack_prepends_an_unsharded_layer_axis():
    decls = {"w": param.PDecl((4, 8), sh.PartitionSpec("fsdp", "tp"))}
    stacked = param.stack(decls, 3)
    assert stacked["w"].shape == (3, 4, 8)
    assert tuple(stacked["w"].spec) == (None, "fsdp", "tp")
    assert tuple(param.param_specs(stacked)["w"]) == (None, "fsdp", "tp")


def test_activate_mesh_and_shard():
    """``shard`` is the identity on every mesh, the production (16, 16)
    among them (the layers issue the tensor-parallel collectives
    themselves); a mesh of other axes raises."""
    x = object()
    assert mesh.current_mesh() is None and sh.shard(x, "batch") is x
    single = mesh.make_production_mesh()
    data_only = MetaMesh((4, 1), ("data", "model"))
    with mesh.activate_mesh(data_only) as m:
        assert m is data_only and mesh.current_mesh() is data_only
        assert sh.shard(x, "batch", None, "tp") is x
        with mesh.activate_mesh(single):
            assert mesh.current_mesh() is single
            assert sh.shard(x, "batch", None, "tp") is x
            with mesh.activate_mesh(MetaMesh((2, 2), ("data", "expert"))):
                with pytest.raises(ValueError, match="expert"):
                    sh.shard(x, "batch", None, "tp")
        assert mesh.current_mesh() is data_only
    assert mesh.current_mesh() is None


@pytest.mark.parametrize("shape,axes,want", [
    ((4, 1), ("data", "model"), ("data",)),
    ((2, 4, 1), ("pod", "data", "model"), ("pod", "data")),
])
def test_data_parallel_shards_every_fsdp_leaf_on_one_dim(shape, axes, want):
    axis = dp.data_axis(MetaMesh(shape, axes))
    assert axis.dims == want and axis.size == math.prod(shape)
    assert axis.groups == [list(range(axis.size))] and axis.index == 0
    model = api.Model(configs.get_config("qwen3_4b"), device="meta")
    dims = param.tree_flatten(dp.shard_dims(model, axis))[0]
    specs = param.tree_flatten(model.specs())[0]
    for d, s in zip(dims, specs):
        assert (d is None) == ("fsdp" not in tuple(s))
        if d is not None:
            assert tuple(s)[d] == "fsdp"
    # a model axis above 1: the same data shards, and each "tp" leaf's
    # part along its tp dim
    tp_mesh = MetaMesh(tuple(s if a != "model" else 2
                             for s, a in zip(shape, axes)), axes)
    axis = dp.data_axis(tp_mesh)
    assert axis.dims == want and axis.size == math.prod(shape)
    assert param.tree_flatten(dp.shard_dims(model, axis))[0] == dims
    model_axis = dp.model_axis(tp_mesh)
    assert model_axis.dims == ("model",) and model_axis.size == 2
    assert dp.model_axis(MetaMesh(shape, axes)) is None
    mdims = param.tree_flatten(dp.shard_dims(model, model_axis))[0]
    for d, s in zip(mdims, specs):
        assert (d is None) == ("tp" not in tuple(s))
        if d is not None:
            assert tuple(s)[d] == "tp"
