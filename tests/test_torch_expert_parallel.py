"""The model axis for every architecture, the port against the
reference: experts sharded over ``ep``, ``attn_dp``, heads that do not
split into whole kv groups a rank, and RWKV-6 blocks, each at SMOKE
width in f32, cell (32, 8), on (data, model) meshes of 4 gloo ranks on
the CPU.  Each case's first-step loss and whole gradients are held
against the reference's jitted ``value_and_grad`` on the same mesh
shape (8 emulated host devices, one subprocess, the port's weights and
batch) and against the port's one device; the live traces against the
lowered ones; the port's and XLA's collectives of the MoE step side by
side; then Jamba-52B, Qwen3-MoE-235B and RWKV6-7B at full width lowered
on ``meta`` on the production (16, 16) mesh.

The port's expert-parallel collectives are not XLA's op for op
(``ROADMAP.md`` section 3): a model group's ranks route the same tokens
and sum their experts' partial combines (*g*), with *f* on the tokens
and the router weights, so every model-axis op is an all-reduce or an
all-gather of the tensor-parallel kind.  XLA, too, keeps the experts'
collectives inside the model groups (no all-to-all over ``model``), and
lowers the embedding as an all-to-all over ``data`` and adds
collective-permutes; both lists are pinned."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import selective_scan as ss
from repro_torch.launch import lowering, placement as pl
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.world import run_world
from repro_torch.models import moe
from repro_torch.models.api import Model
from repro_torch.models.config import shape_cell
from repro_torch.models.param import tree_flatten

import _torch_ep_world as epw
import _torch_tp_world as tpw
from _torch_serve import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600
EP16 = dict(num_experts=16)
# name -> (arch, config overrides, (data, model) shape, whole step too)
CASES = {
    "moe-2x2": ("qwen3_moe_235b_a22b", EP16, (2, 2), True),
    # capped capacity: tokens drop, and an expert's drops are decided on
    # the whole buffer though a rank holds a quarter of its rows
    "moe-1x4": ("qwen3_moe_235b_a22b",
                dict(EP16, moe_combine="scatter", moe_capacity_factor=1.25,
                     attn_dp=True), (1, 4), False),
    "jamba-2x2": ("jamba_v0_1_52b", EP16, (2, 2), True),
    "rwkv-2x2": ("rwkv6_7b", {}, (2, 2), False),
    "rwkv-1x4": ("rwkv6_7b", {}, (1, 4), False),
    # 2 heads on 4 ranks: half a head a rank, q gathered as under attn_dp
    "halfhead-1x4": ("qwen3_4b", dict(num_heads=2, num_kv_heads=1,
                                      head_dim=32), (1, 4), False),
}
NAMES = sorted(CASES)
TRACED = tuple(n for n in NAMES if CASES[n][3])    # live == lowered
COMPILED = ("moe-2x2",)                             # XLA's ops read
TOL = 1e-5

REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.launch.mesh import activate_mesh
    from repro.models.api import Model, batch_partition_specs
    from repro.models.config import ShapeCell
    from repro.parallel import sharding as sh
    from repro.topology import hlocost

    cases, cell, inputs, compiled, out = json.loads(sys.argv[1])
    cell = ShapeCell("train", cell[0], cell[1], "train")

    def shardings(mesh, tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                            is_leaf=lambda x: isinstance(x, P))

    hlo = {}
    for name, (arch, overrides, shape, _) in cases.items():
        cfg = configs.smoke_config(arch).with_overrides(
            compute_dtype=jnp.float32, **overrides)
        model = Model(cfg)
        data = np.load(inputs[name])
        treedef = jax.tree.structure(model.abstract())
        params = jax.tree.unflatten(treedef, [
            jnp.asarray(data[f"p{i}"]) for i in range(treedef.num_leaves)])
        batch = {"tokens": jnp.asarray(data["tokens"]),
                 "labels": jnp.asarray(data["labels"])}
        n = int(np.prod(shape))
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))
        rules = sh.rules_for_mesh(mesh)
        with sh.use_rules(rules), activate_mesh(mesh):
            pspecs = sh.resolve_tree(model.specs(), rules)
            bspecs = sh.resolve_tree(batch_partition_specs(cfg, cell), rules)
            loss_fn = lambda p, b: model.loss(p, b, num_groups=shape[0])
            f = jax.jit(jax.value_and_grad(loss_fn), in_shardings=(
                shardings(mesh, pspecs),
                {k: NamedSharding(mesh, v) for k, v in bspecs.items()}))
            loss, grads = f(params, batch)
            if name in compiled:
                text = f.lower(params, batch).compile().as_text()
                ids = np.arange(n).reshape(shape)
                axes = {"model": ids.tolist(), "data": ids.T.tolist()}
                counts = {}
                for op in hlocost.analyze(text, n).collective_ops:
                    axis = next((a for a, g in axes.items()
                                 if op.groups == g), "other")
                    key = f"{axis} {op.kind}"
                    counts[key] = counts.get(key, 0) + 1
                hlo[name] = counts
        np.savez(f"{out}.{name}.npz", loss=np.asarray(loss),
                 **{f"g{i}": np.asarray(g)
                    for i, g in enumerate(jax.tree.leaves(grads))})
    with open(out, "w") as f:
        json.dump(hlo, f)
""")


def _gap(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _logical_mesh(shape):
    return Mesh(np.arange(int(np.prod(shape)), dtype=object).reshape(shape),
                tpw.AXES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference, ranks)``: the reference's loss and gradients by case
    and its MoE step's collectives by (axis, kind); every rank's
    ``_torch_ep_world.ep_rank`` of all the cases, in one world."""
    tmp = tmp_path_factory.mktemp("expert_parallel")
    inputs = {}
    for name, (arch, overrides, _, _) in CASES.items():
        cfg = epw.config(arch, overrides)
        first = tpw.batch(cfg, 0)
        leaves = tree_flatten(epw.numpy_weights(arch, overrides))[0]
        inputs[name] = str(tmp / f"{name}.npz")
        np.savez(inputs[name], tokens=first["tokens"].numpy(),
                 labels=first["labels"].numpy(),
                 **{f"p{i}": p for i, p in enumerate(leaves)})
    out = tmp / "reference.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    arg = json.dumps([CASES, (tpw.CELL.seq_len, tpw.CELL.global_batch),
                      inputs, COMPILED, str(out)])
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, arg], env=env,
                           cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_world(epw.ep_rank, 4, device_type="cpu",
                          timeout_s=TIMEOUT_S,
                          args=([CASES[n] for n in NAMES],))
        _, err = ref.communicate(timeout=TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    with open(out) as f:
        reference = {"hlo": json.load(f)}
    for name in NAMES:
        with np.load(f"{out}.{name}.npz") as data:
            reference[name] = (float(data["loss"]),
                               [data[f"g{i}"]
                                for i in range(len(data.files) - 1)])
    return reference, {name: [rank[i] for rank in ranks]
                       for i, name in enumerate(NAMES)}


@pytest.fixture(scope="module")
def one_device():
    return {name: epw.one_device(arch, overrides)
            for name, (arch, overrides, _, _) in CASES.items()}


@pytest.fixture(scope="module")
def witness():
    """The RWKV cases' f64 gradients on one device (the CPU): the f32
    distance from them of the one-device step bars an ill-conditioned
    leaf (at RWKV's own init the first token's time-mix output is 0 and
    its group norm divides by sqrt(eps))."""
    return {name: epw.one_device(arch, overrides, torch.float64)[1]
            for name, (arch, overrides, _, _) in CASES.items()
            if arch == "rwkv6_7b"}


# The RWKV leaves whose f32 gradient in a (2, 2) or (1, 4) world lies
# further than TOL from the reference's on the same mesh (1.02e-05 to
# 2.06e-05; from one device's, 6.2e-06 at most): each is held to TOL
# plus the one-device f32 gradient's own gap from the f64 witness
# (1.43e-05 to 2.41e-05).
WITNESS_LEAVES = {name: {
    "embed.embedding", "unit.0.norm1.scale", "unit.0.tm.decay_base",
    "unit.0.tm.ln_scale", "unit.0.tm.mu_g", "unit.0.tm.mu_k",
    "unit.0.tm.mu_r", "unit.0.tm.wg", "unit.0.tm.wk", "unit.0.tm.wr",
    "unit.0.tm.wv"} for name in ("rwkv-2x2", "rwkv-1x4")}


# ------------------------------------------------------------ the worlds

@pytest.mark.parametrize("name", NAMES)
def test_first_step_equals_the_reference_and_one_device(runs, one_device,
                                                        witness, name):
    ref_loss, ref_grads = runs[0][name]
    loss, grads = one_device[name]
    assert ref_loss == pytest.approx(loss, rel=TOL)
    paths = [".".join(map(str, p)) for p in _leaf_paths(name)]
    # TOL, or for a named RWKV leaf TOL plus the one-device f32
    # gradient's own gap from the f64 witness
    bars = [TOL + _gap(g, witness[name][i])
            if path in WITNESS_LEAVES.get(name, ()) else TOL
            for i, (g, path) in enumerate(zip(grads, paths))]
    for rank, result in enumerate(runs[1][name]):
        assert result["loss"] == pytest.approx(ref_loss, rel=TOL)
        assert result["loss"] == pytest.approx(loss, rel=TOL)
        got = result["grads"]
        assert len(got) == len(grads) == len(ref_grads) == len(paths)
        for i, (g, want, ref) in enumerate(zip(got, grads, ref_grads)):
            assert g.shape == want.shape == ref.shape
            assert _gap(g, ref) < bars[i], (rank, paths[i], _gap(g, ref))
            assert _gap(g, want) < bars[i], (rank, paths[i], _gap(g, want))


def _leaf_paths(name):
    """Each parameter leaf's path, in leaf order."""
    arch, overrides, _, _ = CASES[name]

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from walk(tree[k], prefix + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from walk(v, prefix + (i,))
        else:
            yield prefix
    return list(walk(Model(epw.config(arch, overrides),
                           device="meta").abstract(), ()))


@pytest.mark.parametrize("name", ("moe-2x2", "moe-1x4", "jamba-2x2"))
def test_router_gradients_are_whole_over_model_once(runs, one_device,
                                                    name):
    """The router is replicated over ``model`` and its weights enter a
    rank's experts through *f*: each rank's router gradient is whole,
    as one device's.  A missing *f* leaves the rank's experts' part; a
    second sum multiplies by the axis's size: each is far outside the
    bar."""
    paths = [".".join(map(str, p)) for p in _leaf_paths(name)]
    grads = one_device[name][1]
    checked = 0
    for i, path in enumerate(paths):
        if not path.endswith("router"):
            continue
        assert np.linalg.norm(grads[i]) > 0
        for result in runs[1][name]:
            assert _gap(result["grads"][i], grads[i]) < TOL, path
        checked += 1
    assert checked == (1 if name.startswith("moe") else 4)


def test_capped_capacity_drops_tokens(one_device):
    """The (1, 4) MoE case's capacity factor 1.25 drops tokens: its loss
    is not the dropless one's."""
    arch, overrides, _, _ = CASES["moe-1x4"]
    dropless = epw.one_device(arch, dict(overrides, moe_capacity_factor=0.0))
    assert one_device["moe-1x4"][0] != dropless[0]


@pytest.mark.parametrize("name", TRACED)
def test_live_trace_is_the_lowered_trace(runs, name):
    arch, overrides, shape, _ = CASES[name]
    cell = lowering.lower_train_cell(epw.config(arch, overrides), tpw.CELL,
                                     _logical_mesh(shape))
    assert len(cell.collectives) > 0
    for result in runs[1][name]:
        assert result["step_trace"] == cell.collectives


def _by_axis(ops, shape):
    ids = np.arange(int(np.prod(shape))).reshape(shape)
    axes = {"model": ids.tolist(), "data": ids.T.tolist()}
    counts = {}
    for op in ops:
        axis = next(a for a, g in axes.items() if op.groups == g)
        counts[f"{axis} {op.kind}"] = counts.get(f"{axis} {op.kind}", 0) + 1
    return counts


def test_moe_collectives_beside_xla(runs):
    """Qwen3-MoE SMOKE with 16 experts at (2, 2): the port's first step
    (``value_and_grad`` and the data axis's gradient reductions) by
    (axis, kind) on every rank, and XLA's ``value_and_grad`` of the same
    step, pinned.  Both keep the experts' collectives inside the model
    groups: neither has an all-to-all over ``model``."""
    for result in runs[1]["moe-2x2"]:
        assert _by_axis(result["trace"], (2, 2)) == PORT_OPS
    assert runs[0]["hlo"]["moe-2x2"] == XLA_OPS


PORT_OPS = {"model all-reduce": 26, "model all-gather": 8,
            "model reduce-scatter": 4, "data all-gather": 10,
            "data reduce-scatter": 10, "data all-reduce": 6}
XLA_OPS = {"model all-reduce": 20, "model all-gather": 18,
           "data all-gather": 37, "data all-reduce": 9,
           "data all-to-all": 1, "other collective-permute": 5}


# ------------------------------------------------------------- pieces

def test_the_moe_histogram_is_bincount():
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 16, 300))
    assert torch.equal(moe._histogram(ids, 16),
                       torch.bincount(ids, minlength=16))
    meta = moe._histogram(ids.to("meta"), 16)
    assert meta.device.type == "meta" and meta.shape == (16,)


def test_selective_scan_on_meta_gives_shapes_alone():
    b, s, d, n = 2, 5, 6, 4
    args = [torch.empty(shape, device="meta", requires_grad=True)
            for shape in ((b, s, d), (b, s, d), (d, n), (b, s, n),
                          (b, s, n))]
    y, h = ss.SelectiveScan.apply(*args)
    assert y.device.type == h.device.type == "meta"
    assert y.shape == (b, s, d) and h.shape == (b, d, n)
    grads = torch.autograd.grad(y.sum() + h.sum(), args)
    assert [g.shape for g in grads] == [a.shape for a in args]
    assert all(g.device.type == "meta" for g in grads)


# ----------------------------------------------- the production mesh

FULL = {"jamba_v0_1_52b": dict(num_layers=8, layer_pattern="mMmMaMmM"),
        "qwen3_moe_235b_a22b": dict(num_layers=2, layer_pattern="EE"),
        "rwkv6_7b": dict(num_layers=2, layer_pattern="RR")}


@pytest.mark.parametrize("arch", sorted(FULL))
def test_full_width_lowers_on_the_production_mesh(arch):
    """Full width (depth cut for time: one ``mMmMaMmM`` super-block for
    Jamba, 2 layers for the others) on (16, 16): ``train_4k`` lowered on
    ``meta``, model-group and data-group ops only, and C of order 256."""
    cfg = configs.get_config(arch).with_overrides(**FULL[arch])
    mesh = make_production_mesh()
    cell = lowering.lower_train_cell(cfg, shape_cell("train_4k"), mesh)
    assert cell.num_devices == 256 and cell.mesh_shape == (16, 16)
    data = np.arange(256).reshape(16, 16).T.tolist()
    model = np.arange(256).reshape(16, 16).tolist()
    on = {"data": set(), "model": set()}
    for op in cell.collectives:
        assert op.groups in (data, model)
        on["model" if op.groups == model else "data"].add(op.kind)
    assert on["model"] >= {"all-reduce", "all-gather"}
    assert on["data"] == {"all-gather", "all-reduce", "reduce-scatter"}
    c = pl.traffic_from_compiled(cell, 256)
    assert c.shape == (256, 256) and c.sum() > 0
