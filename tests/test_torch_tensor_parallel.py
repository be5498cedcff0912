"""The tensor-parallel ``model`` axis, the port against the reference:
Qwen3's and Jamba's SMOKE configs in f32, cell (32, 8), on (data,
model) meshes (2, 2) and (1, 4) of 4 gloo ranks on the CPU -- the first
step's loss and whole gradients against the reference's jitted
``value_and_grad`` on the same mesh shape (8 emulated host devices, one
subprocess, the port's weights and batch) and against the port's one
device, three steps' losses, the live trace against the lowered one --
then the program graph C of Qwen3's step against the reference's and
the placement it gives, ``launch.train.train`` on a placed (2, 2) mesh,
and Qwen3-4B at full width lowered on the production (16, 16) mesh.

The port's collectives are not XLA's op for op (``ROADMAP.md`` section
3): each layer issues Megatron-LM's f and g and gathers k and v, while
XLA's partitioner also lowers the embedding as all-to-alls, adds a
collective-permute, and splits part of a 4-way model axis into pairs
for the SMOKE model's 2 kv heads.  So C is compared by what it costs the
placements, not entry by entry."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.topology import hlocost as ref_hlocost
from repro.topology import traffic as ref_traffic
from repro_torch import configs
from repro_torch.core import annealing, genetic
from repro_torch.launch import lowering, placement as pl
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh, make_mesh_with_devices
from repro_torch.launch.world import run_world
from repro_torch.models.api import Model
from repro_torch.models.config import shape_cell
from repro_torch.models.param import tree_flatten
from repro_torch.topology import tpu

import _torch_tp_world as tpw
from _torch_serve import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600
ARCHS = ("qwen3_4b", "jamba_v0_1_52b")
SHAPES = {"2x2": (2, 2), "1x4": (1, 4)}
PLACED = (3, 1, 0, 2)          # a placed order of the 4 ranks
SMALL_SA = dict(max_neighbors=10, iters_per_exchange=8, num_exchanges=4,
                solvers=4, seed_with="identity")
SMALL_GA = dict(generations=15, pop_size=12, seed_identity=True)
RING_KINDS = ("all-gather", "all-reduce", "reduce-scatter")
CASES = [(a, s) for a in ARCHS for s in SHAPES]
IDS = [f"{a}-{s}" for a, s in CASES]

REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.core import annealing, genetic
    from repro.launch import placement as pl
    from repro.launch.mesh import activate_mesh
    from repro.models.api import Model, batch_partition_specs, input_specs
    from repro.models.config import ShapeCell
    from repro.parallel import sharding as sh
    from repro.topology import hlocost, tpu, traffic
    from repro.train import optimizer as opt_lib
    from repro.train.step import make_train_step

    archs, shapes, cell, inputs, small_sa, small_ga, ring_kinds, out = \\
        json.loads(sys.argv[1])
    cell = ShapeCell("train", cell[0], cell[1], "train")

    def mesh_of(shape):
        n = int(np.prod(shape))
        return Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))

    def shardings(mesh, tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                            is_leaf=lambda x: isinstance(x, P))

    result = {"grads": {}, "hlo": {}}
    for arch in archs:
        cfg = configs.smoke_config(arch).with_overrides(
            compute_dtype=jnp.float32)
        model = Model(cfg)
        data = np.load(inputs[arch])
        treedef = jax.tree.structure(model.abstract())
        params = jax.tree.unflatten(treedef, [
            jnp.asarray(data[f"p{i}"]) for i in range(treedef.num_leaves)])
        batch = {"tokens": jnp.asarray(data["tokens"]),
                 "labels": jnp.asarray(data["labels"])}
        for name, shape in shapes.items():
            mesh = mesh_of(shape)
            rules = sh.rules_for_mesh(mesh)
            with sh.use_rules(rules), activate_mesh(mesh):
                pspecs = sh.resolve_tree(model.specs(), rules)
                bspecs = sh.resolve_tree(batch_partition_specs(cfg, cell),
                                         rules)
                loss_fn = lambda p, b: model.loss(p, b,
                                                  num_groups=shape[0])
                f = jax.jit(jax.value_and_grad(loss_fn), in_shardings=(
                    shardings(mesh, pspecs),
                    {k: NamedSharding(mesh, v) for k, v in bspecs.items()}))
                loss, grads = f(params, batch)
            np.savez(f"{out}.{arch}.{name}.npz", loss=np.asarray(loss),
                     **{f"g{i}": np.asarray(g)
                        for i, g in enumerate(jax.tree.leaves(grads))})

    # Qwen3's train step compiled on each mesh: its HLO and the placement
    # of its ring collectives' C on the mesh's torus
    cfg = configs.smoke_config("qwen3_4b")
    model = Model(cfg)
    ocfg = opt_lib.OptConfig(lr=3e-4, moment_dtype=cfg.opt_dtype)
    for name, shape in shapes.items():
        mesh = mesh_of(shape)
        n = int(np.prod(shape))
        rules = sh.rules_for_mesh(mesh)
        with sh.use_rules(rules), activate_mesh(mesh):
            pspecs = sh.resolve_tree(model.specs(), rules)
            bspecs = sh.resolve_tree(batch_partition_specs(cfg, cell), rules)
            step = jax.jit(make_train_step(
                model, ocfg, opt_lib.warmup_cosine(3e-4, 1, 3),
                num_groups=shape[0]), in_shardings=(
                shardings(mesh, pspecs),
                shardings(mesh, opt_lib.state_specs(ocfg, pspecs)),
                {k: NamedSharding(mesh, v) for k, v in bspecs.items()}),
                donate_argnums=(0, 1))
            aparams = model.abstract()
            compiled = step.lower(aparams, opt_lib.abstract_state(
                ocfg, aparams), input_specs(cfg, cell)).compile()
        text = compiled.as_text()
        c = np.zeros((n, n), np.float64)
        for op in hlocost.analyze(text, n).collective_ops:
            if op.kind in ring_kinds:
                c += traffic.traffic_matrix([op], n).astype(np.float64)
        ring = c.astype(np.float32)
        m = tpu.distance_matrix(tpu.spec_for_mesh_shape(shape))
        pl.reset_default_service()
        pl._SERVICE = pl.PlacementService(
            sa_cfg=annealing.SAConfig(**small_sa),
            ga_cfg=genetic.GAConfig(**small_ga))
        res = pl.solve_placement(ring, m, "psa")
        result["hlo"][name] = {
            "text": text, "perm": [int(x) for x in res.perm],
            "cost_before": float(res.cost_before),
            "cost_after": float(res.cost_after)}
    with open(out, "w") as f:
        json.dump(result, f)
""")


def _small_service():
    return pl.PlacementService(sa_cfg=annealing.SAConfig(**SMALL_SA),
                               ga_cfg=genetic.GAConfig(**SMALL_GA),
                               device="cpu")


def _logical_mesh(shape, axes=tpw.AXES):
    return Mesh(np.arange(int(np.prod(shape)), dtype=object).reshape(shape),
                axes)


def _gap(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference, worlds, placed)``: the reference's losses and
    gradients by (arch, mesh) and its compiled Qwen3 step by mesh; each
    rank's ``_torch_tp_world.tp_rank`` by (arch, mesh); and
    ``launch.train.train`` of Qwen3 on the (2, 2) mesh of the CPU with
    ``placement="psa"`` (small budgets)."""
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    inputs = {}
    for arch in ARCHS:
        cfg = tpw.config(arch)
        first = tpw.batch(cfg, 0)
        leaves = tree_flatten(tpw.numpy_weights(arch))[0]
        inputs[arch] = str(tmp / f"{arch}.npz")
        np.savez(inputs[arch], tokens=first["tokens"].numpy(),
                 labels=first["labels"].numpy(),
                 **{f"p{i}": p for i, p in enumerate(leaves)})
    out = tmp / "reference.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    arg = json.dumps([ARCHS, SHAPES, (tpw.CELL.seq_len,
                                      tpw.CELL.global_batch), inputs,
                      SMALL_SA, SMALL_GA, RING_KINDS, str(out)])
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, arg], env=env,
                           cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    mp = pytest.MonkeyPatch()
    try:
        worlds = {(arch, name): run_world(
            tpw.tp_rank, 4, device_type="cpu", timeout_s=TIMEOUT_S,
            args=(arch, shape, PLACED))
            for arch, (name, shape) in [(a, s) for a in ARCHS
                                        for s in SHAPES.items()]}
        service = _small_service()
        mp.setattr(pl, "PlacementService", lambda device: service)
        mesh = make_mesh_with_devices(["cpu"] * 4, SHAPES["2x2"], tpw.AXES)
        placed = launch_train.train(
            tpw.config("qwen3_4b"), steps=tpw.STEPS,
            global_batch=tpw.CELL.global_batch, seq_len=tpw.CELL.seq_len,
            lr=tpw.LR, warmup=tpw.WARMUP, placement="psa", mesh=mesh,
            log_every=1, seed=tpw.SEED)
        _, err = ref.communicate(timeout=TIMEOUT_S)
    finally:
        mp.undo()
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    with open(out) as f:
        reference = json.load(f)
    for arch, name in CASES:
        with np.load(f"{out}.{arch}.{name}.npz") as data:
            reference["grads"][arch, name] = (
                float(data["loss"]),
                [data[f"g{i}"] for i in range(len(data.files) - 1)])
    return reference, worlds, placed


@pytest.fixture(scope="module")
def one_device():
    return {arch: tpw.one_device(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def lowered():
    """Qwen3's f32 SMOKE step lowered on each mesh, and on (1, 2, 2)."""
    cfg = tpw.config("qwen3_4b")
    out = {name: lowering.lower_train_cell(cfg, tpw.CELL,
                                           _logical_mesh(shape))
           for name, shape in SHAPES.items()}
    out["1x2x2"] = lowering.lower_train_cell(
        cfg, tpw.CELL, _logical_mesh((1, 2, 2), ("pod", "data", "model")))
    return out


@pytest.fixture(autouse=True)
def fresh_port_service():
    pl.reset_default_service()
    yield
    pl.reset_default_service()


# ------------------------------------------------------------ the worlds

@pytest.mark.parametrize("arch,name", CASES, ids=IDS)
def test_first_step_equals_the_reference_and_one_device(runs, one_device,
                                                        arch, name):
    ref_loss, ref_grads = runs[0]["grads"][arch, name]
    loss, grads, _ = one_device[arch]
    assert ref_loss == pytest.approx(loss, rel=1e-5)
    for rank, result in enumerate(runs[1][arch, name]):
        got_loss, got, _ = result["first"]
        assert got_loss == pytest.approx(ref_loss, rel=1e-5)
        assert got_loss == pytest.approx(loss, rel=1e-5)
        assert len(got) == len(grads) == len(ref_grads)
        for i, (g, want, ref) in enumerate(zip(got, grads, ref_grads)):
            assert g.shape == want.shape == ref.shape
            assert _gap(g, ref) < 1e-5, (rank, i, _gap(g, ref))
            assert _gap(g, want) < 1e-5, (rank, i, _gap(g, want))


@pytest.mark.parametrize("arch,name", CASES, ids=IDS)
def test_placed_first_step_equals_one_device(runs, one_device, arch, name):
    """The same ranks in the ``PLACED`` order: position k on rank
    ``PLACED[k]``, so every group's ranks differ from their positions."""
    loss, grads, _ = one_device[arch]
    for rank, result in enumerate(runs[1][arch, name]):
        got_loss, got, trace = result["placed"]
        assert got_loss == pytest.approx(loss, rel=1e-5)
        for i, (g, want) in enumerate(zip(got, grads)):
            assert _gap(g, want) < 1e-5, (rank, i, _gap(g, want))
        assert trace == result["first"][2]


@pytest.mark.parametrize("arch,name", CASES, ids=IDS)
def test_norm_scale_gradients_are_summed_over_model_once(runs, one_device,
                                                         arch, name):
    """``q_norm`` and ``k_norm`` scale what serves a rank's q heads only:
    each rank's gradient is a part, summed over ``model`` by *f*; the
    ``rmsnorm`` scales see the replicated stream, whole already.  A
    missing sum leaves a part, a second one multiplies by the axis's
    size: each is far outside the bar."""
    names = [".".join(map(str, path)) for path in _leaf_paths(arch)]
    _, grads, _ = one_device[arch]
    checked = 0
    for i, path in enumerate(names):
        if not path.endswith(("q_norm", "k_norm", "scale")):
            continue
        want = grads[i]
        assert np.linalg.norm(want) > 0
        for result in runs[1][arch, name]:
            assert _gap(result["first"][1][i], want) < 1e-5, path
        checked += 1
    assert checked == (5 if arch == "qwen3_4b" else 17)


def _leaf_paths(arch):
    """Each parameter leaf's path, in leaf order."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from walk(tree[k], prefix + (k,))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from walk(v, prefix + (i,))
        else:
            yield prefix
    return list(walk(Model(tpw.config(arch), device="meta").abstract(), ()))


@pytest.mark.parametrize("arch,name", CASES, ids=IDS)
def test_losses_over_three_steps_equal_one_device(runs, one_device, arch,
                                                  name):
    want = one_device[arch][2]
    for result in runs[1][arch, name]:
        np.testing.assert_allclose(result["losses"], want, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_live_trace_is_the_lowered_trace(runs, lowered, name):
    cell = lowered[name]
    assert len(cell.collectives) > 0
    for result in runs[1]["qwen3_4b", name]:
        for trace in result["traces"]:
            assert trace == cell.collectives


def test_jamba_worlds_issue_one_trace_on_every_rank_and_step(runs):
    """Jamba's live traces: one list on every rank and step, with
    model-group and data-group ops on the (2, 2) mesh, and that list
    the lowered cell's (its MoE routing and Mamba scan run on
    ``meta``)."""
    cfg = tpw.config("jamba_v0_1_52b")
    for name, shape in SHAPES.items():
        traces = [t for r in runs[1]["jamba_v0_1_52b", name]
                  for t in r["traces"]]
        assert all(t == traces[0] for t in traces)
        lowered = lowering.lower_train_cell(cfg, tpw.CELL,
                                            _logical_mesh(shape))
        assert traces[0] == lowered.collectives
    groups = {tuple(map(tuple, op.groups))
              for op in runs[1]["jamba_v0_1_52b", "2x2"][0]["traces"][0]}
    assert groups == {((0, 1), (2, 3)), ((0, 2), (1, 3))}


def test_placed_world_trains_as_the_unplaced_one(runs, lowered):
    """``launch.train.train(placement="psa")`` on the (2, 2) mesh: the
    2 x 2 torus joins each model pair and each data pair, so the mesh's
    own order is the placement (gain 0, as the reference's); the
    unplaced world's losses, every rank's collectives the lowered
    cell's, and the whole parameters back on rank 0 (gathered over both
    axes).  A placed order of these ranks is held in
    :func:`test_placed_first_step_equals_one_device`."""
    placed = runs[2]
    assert placed["placement"]["perm"] == [0, 1, 2, 3]
    assert placed["placement"]["gain"] == 0.0
    got = [h["loss"] for h in placed["history"]]
    assert [h["step"] for h in placed["history"]] == [1, 2, 3]
    np.testing.assert_allclose(got, runs[1]["qwen3_4b", "2x2"][0]["losses"],
                               rtol=1e-6)
    for rank in placed["ranks"]:
        assert rank["trace"] == lowered["2x2"].collectives
    cfg = tpw.config("qwen3_4b")
    shapes = [tuple(p.shape) for p in tree_flatten(
        Model(cfg, device="cpu").abstract())[0]]
    params = tree_flatten(placed["params"])[0]
    assert [tuple(p.shape) for p in params] == shapes
    assert all(p.device.type == "cpu" and torch.isfinite(p).all()
               for p in params)


def test_k8_runs_on_each_ranks_channel_slice(runs):
    """The world's Mamba layers run on ``d_inner / m`` channels a rank
    (the plain scan on the CPU: no launch counted here; the card's world
    counts K8's launches, ``tests/test_torch_cuda.py``)."""
    for name in SHAPES:
        for result in runs[1]["jamba_v0_1_52b", name]:
            assert result["launches"]["selective_scan"] == 0


# ------------------------------------------------------------- lowering

@pytest.mark.parametrize("name", sorted(SHAPES) + ["1x2x2"])
def test_lowered_ops_run_over_model_and_data_groups(lowered, name):
    cell = lowered[name]
    n = cell.num_devices
    assert n == 4
    data = [[0, 2], [1, 3]] if name != "1x4" else [[0], [1], [2], [3]]
    model = [[0, 1], [2, 3]] if name != "1x4" else [[0, 1, 2, 3]]
    kinds = {}
    for op in cell.collectives:
        assert op.groups in (data, model), op
        kinds.setdefault((op.kind, op.groups == model), 0)
        kinds[op.kind, op.groups == model] += 1
    assert {k for k, on_model in kinds if on_model} == set(RING_KINDS)
    assert {k for k, on_model in kinds if not on_model} == set(RING_KINDS)
    if name == "1x2x2":
        assert cell.collectives == lowered["2x2"].collectives


def test_the_data_parallel_lowering_is_unchanged_on_a_model_axis_of_one():
    cfg = tpw.config("qwen3_4b")
    cell = lowering.lower_train_cell(cfg, tpw.CELL, _logical_mesh((4, 1)))
    assert {op.kind for op in cell.collectives} == set(RING_KINDS)
    assert all(op.groups == [[0, 1, 2, 3]] for op in cell.collectives)
    assert len(cell.collectives) == 25


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_traffic_places_against_the_reference(runs, lowered, name):
    """C of the port and of the reference's ring collectives on the 2 x 2
    torus: the placements, each priced under the reference's C, and the
    two gains, pinned.  The two C's differ (XLA's ops are not the
    port's): at unit sum they are pinned apart, not equal."""
    n = 4
    m = tpu.distance_matrix(tpu.spec_for_mesh_shape(SHAPES[name]))
    text = runs[0]["hlo"][name]["text"]
    c_ref = np.zeros((n, n), np.float64)
    for op in ref_hlocost.analyze(text, n).collective_ops:
        if op.kind in RING_KINDS:
            c_ref += ref_traffic.traffic_matrix([op], n).astype(np.float64)
    c_port = pl.traffic_from_compiled(lowered[name], n).astype(np.float64)
    got = _small_service().solve(c_port.astype(np.float32), m, "psa")
    ref = runs[0]["hlo"][name]
    f = lambda c, p: float((c * m[np.ix_(p, p)].astype(np.float64)).sum())
    ref_gain = (ref["cost_before"] - ref["cost_after"]) / ref["cost_before"]
    want = PINNED[name]
    assert got.gain == pytest.approx(want["port_gain"], abs=1e-6)
    assert ref_gain == pytest.approx(want["ref_gain"], abs=1e-6)
    ratio = f(c_ref, got.perm) / f(c_ref, ref["perm"])
    assert ratio == pytest.approx(want["cost_ratio"], abs=1e-6)
    gap = np.abs(c_port / c_port.sum() - c_ref / c_ref.sum()).max()
    assert gap == pytest.approx(want["unit_gap"], abs=1e-6)


# The 2 x 2 torus joins every pair of a (2, 2) mesh's groups, so its own
# order is optimal in both packages; on (1, 4) the port's C is the ring
# of PR 25's (4, 1) mesh (gain 1/3), while XLA's pair groups for the 2 kv
# heads add off-ring traffic (a smaller gain), and both choose one order.
PINNED = {"2x2": dict(port_gain=0.0, ref_gain=0.0, cost_ratio=1.0,
                      unit_gap=0.019478073653),
          "1x4": dict(port_gain=1 / 3, ref_gain=0.291772250909,
                      cost_ratio=1.0, unit_gap=0.022657126695)}


# ----------------------------------------------- the production mesh

def test_qwen3_4b_at_full_width_lowers_on_the_production_mesh():
    """Qwen3-4B at full width (depth cut to 2 for time) on (16, 16):
    ``train_4k`` lowered on ``meta`` (no storage anywhere), model-group
    and data-group ops, and a placement through the multilevel route's
    order (256)."""
    cfg = configs.get_config("qwen3_4b").with_overrides(
        num_layers=2, layer_pattern="TT")
    mesh = _logical_mesh((16, 16))
    cell = lowering.lower_train_cell(cfg, shape_cell("train_4k"), mesh)
    assert cell.num_devices == 256 and cell.mesh_shape == (16, 16)
    data = np.arange(256).reshape(16, 16).T.tolist()
    model = np.arange(256).reshape(16, 16).tolist()
    on = {"data": set(), "model": set()}
    for op in cell.collectives:
        assert op.groups in (data, model)
        on["model" if op.groups == model else "data"].add(op.kind)
    assert on["model"] == on["data"] == set(RING_KINDS)
    c = pl.traffic_from_compiled(cell, 256)
    assert c.shape == (256, 256) and c.sum() > 0
