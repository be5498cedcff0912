"""The paper's placement of an LM training job, the port against the
reference: Qwen3's SMOKE train step lowered on meshes (4, 1), (8, 1)
and (pod 2, data 4, model 1) -- the reference by XLA on 8 emulated host
devices, the port by ``launch.lowering`` on ``meta`` -- its program graph
C, ``place_job`` and the data-parallel world on 4 gloo ranks on the CPU.

What XLA emits besides the port's collectives: its SPMD partitioner
lowers the embedding lookup from a table sharded on ``d_model`` as an
all-to-all of the gathered rows, and the lookup's transpose (the
scatter-add of the gradient) as another (``ROADMAP.md`` section 3).
The port gathers the table and reduce-scatters its gradient like any
other sharded weight, so its C is the reference's ring collectives'
C up to scale; an all-to-all adds the same cost to every permutation's
F, so the placements agree while the reference's gain is smaller.  A
mesh of 8 devices maps onto ``spec_for_mesh_shape``'s 3 x 3 pod of 9
chips, and ``place_job`` raises in both packages; the 8-device
placements are solved on tori of 8 chips (4 x 2, and two 2 x 2 pods).

The reference runs in one subprocess (its device count is fixed when JAX
starts); the port's world and its placed world (``launch.train.train``)
run beside it."""
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import placement as ref_pl
from repro.topology import hlocost as ref_hlocost
from repro.topology import traffic as ref_traffic
from repro_torch import configs
from repro_torch.core import annealing, genetic
from repro_torch.launch import lowering, placement as pl
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import Mesh, make_mesh_with_devices
from repro_torch.launch.world import run_world
from repro_torch.models.api import Model
from repro_torch.models.config import ShapeCell
from repro_torch.models.param import tree_flatten
from repro_torch.topology import tpu
from repro_torch.train import optimizer as opt_lib

import _torch_dp_world as dpw
from _torch_serve import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600
SMALL_SA = dict(max_neighbors=10, iters_per_exchange=8, num_exchanges=4,
                solvers=4, seed_with="identity")
SMALL_GA = dict(generations=15, pop_size=12, seed_identity=True)
CELL = (32, 8)                  # seq_len, global batch
MESHES = {"4x1": ((4, 1), ("data", "model")),
          "8x1": ((8, 1), ("data", "model")),
          "2x4x1": ((2, 4, 1), ("pod", "data", "model"))}
# the 8-chip tori the 8-device placements are solved on
TORI = {"4x1": dict(side_x=2, side_y=2), "8x1": dict(side_x=4, side_y=2),
        "2x4x1": dict(side_x=2, side_y=2, num_pods=2)}
RING_KINDS = ("all-gather", "all-reduce", "reduce-scatter")

REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
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

    meshes, tori, cell, small_sa, small_ga, ring_kinds, out = \\
        json.loads(sys.argv[1])
    def fresh():        # a new default service a solve: no warm start
        pl.reset_default_service()
        pl._SERVICE = pl.PlacementService(
            sa_cfg=annealing.SAConfig(**small_sa),
            ga_cfg=genetic.GAConfig(**small_ga))

    cfg = configs.smoke_config("qwen3_4b")
    model = Model(cfg)
    ocfg = opt_lib.OptConfig(lr=3e-4, moment_dtype=cfg.opt_dtype)
    cell = ShapeCell("train", cell[0], cell[1], "train")

    def placed(res):
        return {"perm": [int(x) for x in res.perm],
                "cost_before": float(res.cost_before),
                "cost_after": float(res.cost_after)}

    def ring_c(text, n):
        c = np.zeros((n, n), np.float64)
        for op in hlocost.analyze(text, n).collective_ops:
            if op.kind in ring_kinds:
                c += traffic.traffic_matrix([op], n).astype(np.float64)
        return c.astype(np.float32)

    result = {}
    for name, (shape, axes) in meshes.items():
        n = int(np.prod(shape))
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)
        rules = sh.rules_for_mesh(mesh)
        dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
        with sh.use_rules(rules), activate_mesh(mesh):
            tree = lambda t: jax.tree.map(
                lambda s: NamedSharding(mesh, s), t,
                is_leaf=lambda x: isinstance(x, P))
            pspecs = sh.resolve_tree(model.specs(), rules)
            bspecs = sh.resolve_tree(batch_partition_specs(cfg, cell), rules)
            step = jax.jit(make_train_step(
                model, ocfg, opt_lib.warmup_cosine(3e-4, 1, 3),
                num_groups=dp), in_shardings=(
                tree(pspecs), tree(opt_lib.state_specs(ocfg, pspecs)),
                {k: NamedSharding(mesh, v) for k, v in bspecs.items()}),
                donate_argnums=(0, 1))
            aparams = model.abstract()
            compiled = step.lower(aparams, opt_lib.abstract_state(
                ocfg, aparams), input_specs(cfg, cell)).compile()
        text = compiled.as_text()
        entry = {"text": text}
        try:
            fresh()
            entry["place_job"] = placed(pl.place_job(compiled, mesh, "psa")[1])
        except ValueError as e:
            entry["place_job_error"] = str(e)
        m = tpu.distance_matrix(tpu.PodSpec(**tori[name]))
        fresh()
        entry["full"] = placed(pl.solve_placement(
            pl.traffic_from_compiled(compiled, n), m, "psa"))
        fresh()
        ring = ring_c(text, n)
        entry["ring"] = placed(pl.solve_placement(ring, m, "psa"))
        fresh()
        entry["unit"] = placed(pl.solve_placement(ring / ring.max(), m, "psa"))
        result[name] = entry
    with open(out, "w") as f:
        json.dump(result, f)
""")


class _Compiled:
    """HLO text behind ``.as_text()``, as a compiled step offers it."""

    def __init__(self, text):
        self._text = text

    def as_text(self):
        return self._text


def _small_service():
    return pl.PlacementService(sa_cfg=annealing.SAConfig(**SMALL_SA),
                               ga_cfg=genetic.GAConfig(**SMALL_GA),
                               device="cpu")


def _logical_mesh(name):
    shape, axes = MESHES[name]
    return Mesh(np.arange(int(np.prod(shape)), dtype=object).reshape(shape),
                axes)


def _ring_c(text, n):
    """The reference's C of its ring collectives alone."""
    c = np.zeros((n, n), np.float64)
    for op in ref_hlocost.analyze(text, n).collective_ops:
        if op.kind in RING_KINDS:
            c += ref_traffic.traffic_matrix([op], n).astype(np.float64)
    return c.astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference, world, placed, resumed)``: the reference's lowered
    cells and placements by mesh; each rank's results of the port's
    unplaced world (``_torch_dp_world.dp_rank``); ``launch.train.train``
    on the (4, 1) mesh of the CPU with ``placement="psa"`` (small
    budgets), checkpointing at steps 2 and 3; and the same call resumed
    from a copy of step 2's checkpoint alone."""
    tmp = tmp_path_factory.mktemp("placement_job")
    out = tmp / "reference.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    arg = json.dumps([MESHES, TORI, CELL, SMALL_SA, SMALL_GA, RING_KINDS,
                      str(out)])
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, arg], env=env,
                           cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    mp = pytest.MonkeyPatch()
    try:
        world = run_world(dpw.dp_rank, dpw.WORLD, device_type="cpu",
                          timeout_s=TIMEOUT_S)
        service = _small_service()
        mp.setattr(pl, "PlacementService", lambda device: service)
        mesh = make_mesh_with_devices(["cpu"] * dpw.WORLD, dpw.MESH_SHAPE,
                                      dpw.AXES)
        kw = dict(steps=dpw.STEPS, global_batch=dpw.CELL.global_batch,
                  seq_len=dpw.CELL.seq_len, lr=dpw.LR, warmup=dpw.WARMUP,
                  placement="psa", mesh=mesh, log_every=1, seed=dpw.SEED,
                  checkpoint_every=2)
        placed = launch_train.train(dpw.config(), checkpoint_dir=str(
            tmp / "ckpt"), **kw)
        shutil.copytree(tmp / "ckpt" / "step_00000002",
                        tmp / "resume" / "step_00000002")
        resumed = launch_train.train(dpw.config(), checkpoint_dir=str(
            tmp / "resume"), **kw)
        placed["checkpoint_dir"] = str(tmp / "ckpt")
        _, err = ref.communicate(timeout=TIMEOUT_S)
    finally:
        mp.undo()
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    with open(out) as f:
        reference = json.load(f)
    return reference, world, placed, resumed


@pytest.fixture(scope="module")
def lowered():
    """The port's lowered cells, by mesh."""
    smoke = configs.smoke_config("qwen3_4b")
    cell = ShapeCell("train", CELL[0], CELL[1], "train")
    return {name: lowering.lower_train_cell(smoke, cell, _logical_mesh(name))
            for name in MESHES}


@pytest.fixture(autouse=True)
def fresh_port_service():
    pl.reset_default_service()
    yield
    pl.reset_default_service()


# ------------------------------------------------------------ lowered C

@pytest.mark.parametrize("name", sorted(MESHES))
def test_traffic_of_the_reference_hlo_equals_the_reference(runs, name):
    text = runs[0][name]["text"]
    n = int(np.prod(MESHES[name][0]))
    got = pl.traffic_from_compiled(text, n)
    assert got.tobytes() == \
        ref_pl.traffic_from_compiled(_Compiled(text), n).tobytes()
    assert got.tobytes() == pl.traffic_from_compiled(_Compiled(text),
                                                     n).tobytes()


@pytest.mark.parametrize("name", sorted(MESHES))
def test_the_reference_adds_only_the_embedding_all_to_alls(runs, name):
    """Every collective of the reference's step runs over the one data
    group in iota order; the non-ring ones are the two all-to-alls of the
    embedding lookup (its gather and the gradient's scatter-add)."""
    text = runs[0][name]["text"]
    n = int(np.prod(MESHES[name][0]))
    ops = ref_hlocost.analyze(text, n).collective_ops
    assert all(op.groups == [list(range(n))] for op in ops)
    assert {op.kind for op in ops} - set(RING_KINDS) == {"all-to-all"}
    lines = [line for line in text.splitlines() if " all-to-all(" in line]
    assert len(lines) == 2 == sum(op.kind == "all-to-all" for op in ops)
    assert any("_take))/gather" in line for line in lines)
    assert any("_take)))/scatter-add" in line for line in lines)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_lowered_traffic_is_the_reference_ring_up_to_scale(runs, lowered,
                                                           name):
    cell = lowered[name]
    n = cell.num_devices
    assert n == int(np.prod(MESHES[name][0]))
    assert cell.mesh_shape == MESHES[name][0]
    assert {op.kind for op in cell.collectives} == set(RING_KINDS)
    assert all(op.groups == [list(range(n))] for op in cell.collectives)
    got = pl.traffic_from_compiled(cell, n).astype(np.float64)
    want = _ring_c(runs[0][name]["text"], n).astype(np.float64)
    assert got.sum() > 0 and want.sum() > 0
    np.testing.assert_allclose(got / got.sum(), want / want.sum(), rtol=0,
                               atol=1e-6)
    ring = np.zeros((n, n))
    ring[np.arange(n), (np.arange(n) + 1) % n] = 1.0 / n
    np.testing.assert_allclose(got / got.sum(), ring, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_lowered_traffic_places_as_the_reference(runs, lowered, name):
    """On the mesh's torus of 8 chips (2 x 2 for 4): the port's C places
    with the reference's ring C's gain, its permutation costs what the
    reference's does under the reference's C, and scaled to a unit
    maximum the two are one matrix and give one permutation.  (Among
    equal-cost optima PSA's pick depends on C's scale: its final
    temperature is absolute; and past 2^24 the f32 sums of F are not
    exact, so the engines agree bit for bit only on the unit scale.)
    The reference's all-to-alls add one cost to every permutation's F."""
    n = lowered[name].num_devices
    m = tpu.distance_matrix(tpu.PodSpec(**TORI[name]))
    text = runs[0][name]["text"]
    c_port = pl.traffic_from_compiled(lowered[name], n)
    c_ring = _ring_c(text, n)
    c_full = ref_pl.traffic_from_compiled(_Compiled(text), n)
    ring, full = runs[0][name]["ring"], runs[0][name]["full"]
    got = _small_service().solve(c_port, m, "psa")
    f = lambda c, p: float((c.astype(np.float64)
                            * m[np.ix_(p, p)].astype(np.float64)).sum())
    gain = lambda r: (r["cost_before"] - r["cost_after"]) / r["cost_before"]
    assert got.gain > 0
    assert got.gain == pytest.approx(gain(ring), rel=0, abs=1e-6)
    assert f(c_ring, got.perm) == pytest.approx(f(c_ring, ring["perm"]),
                                                rel=1e-6)
    unit = c_port / c_port.max()
    assert unit.tobytes() == (c_ring / c_ring.max()).tobytes()
    assert _small_service().solve(unit, m, "psa").perm.tolist() == \
        runs[0][name]["unit"]["perm"]
    identity = np.arange(n)
    extra = {f(c_full, p) - f(c_ring, p)
             for p in (identity, got.perm, ring["perm"], full["perm"])}
    assert max(extra) == pytest.approx(min(extra), rel=1e-6)
    assert min(extra) > 0 and gain(full) < gain(ring)


def test_place_job_on_the_reference_hlo_equals_the_reference(runs):
    want = runs[0]["4x1"]["place_job"]
    mesh = _logical_mesh("4x1")
    placed, got = pl.place_job(runs[0]["4x1"]["text"], mesh, "psa",
                               service=_small_service())
    assert got.perm.tolist() == want["perm"]
    assert np.float32(got.cost_before) == np.float32(want["cost_before"])
    assert np.float32(got.cost_after) == np.float32(want["cost_after"])
    assert placed.devices.reshape(-1).tolist() == want["perm"]
    assert placed.axis_names == mesh.axis_names
    assert got.perm.tolist() != [0, 1, 2, 3]


@pytest.mark.parametrize("name", ["8x1", "2x4x1"])
def test_place_job_on_eight_devices_raises_as_the_reference(runs, lowered,
                                                            name):
    """8 devices fold into a 3 x 3 pod of 9 chips: C and M differ."""
    assert tpu.spec_for_mesh_shape(MESHES[name][0]).num_chips == 9
    with pytest.raises(ValueError) as e:
        pl.place_job(lowered[name], _logical_mesh(name), "psa",
                     service=_small_service())
    assert str(e.value) == runs[0][name]["place_job_error"]


def test_place_job_on_a_ring_of_four_gains_a_third(lowered):
    """The 2 x 2 torus: the ring 0-1-2-3 costs 6 hops a unit of C in the
    identity order, 4 in a placed one."""
    placed, got = pl.place_job(lowered["4x1"], _logical_mesh("4x1"), "psa",
                               service=_small_service())
    assert got.gain == pytest.approx(1 / 3, rel=0, abs=1e-6)
    assert got.perm.tolist() != [0, 1, 2, 3]
    assert sorted(got.perm.tolist()) == [0, 1, 2, 3]


# ------------------------------------------------- the data-parallel world

@pytest.fixture(scope="module")
def one_device():
    return dpw.one_device()


def _lowered_f32():
    return lowering.lower_train_cell(dpw.config(), dpw.CELL,
                                     _logical_mesh("4x1"))


def test_world_gradients_equal_one_device(runs, one_device):
    loss, grads, _ = one_device
    for rank, result in enumerate(runs[1]):
        assert result["loss"] == pytest.approx(loss, rel=1e-5)
        got = tree_flatten(result["grads"])[0]
        assert len(got) == len(grads)
        for g, want in zip(got, grads):
            assert g.shape == want.shape
            gap = np.linalg.norm(g - want) / max(np.linalg.norm(want), 1e-30)
            assert gap < 1e-5, (rank, g.shape, gap)


@pytest.mark.parametrize("which", ["placed", "placed_native"])
def test_placed_world_gradients_equal_one_device(runs, one_device, which):
    """On the placed mesh (position k on rank ``PLACED[k]``) the first
    step's gradients are one device's, with the reduce-scatters as gloo's
    all-reduce and slice and as the backend's own ``reduce_scatter_tensor``
    (the NCCL branch, which hands the shards over in group-rank order)."""
    loss, grads, _ = one_device
    for rank, result in enumerate(runs[1]):
        assert result["backend"] == "gloo"
        got_loss, got = result[which]
        assert got_loss == pytest.approx(loss, rel=1e-5)
        got = tree_flatten(got)[0]
        assert len(got) == len(grads)
        for g, want in zip(got, grads):
            gap = np.linalg.norm(g - want) / max(np.linalg.norm(want), 1e-30)
            assert gap < 1e-5, (rank, g.shape, gap)


def test_world_losses_equal_one_device(runs, one_device):
    want = one_device[2]
    for result in runs[1]:
        np.testing.assert_allclose(result["losses"], want, rtol=1e-5)


def test_world_live_trace_is_the_lowered_trace(runs):
    cell = _lowered_f32()
    assert len(cell.collectives) > 0
    for result in runs[1]:
        for trace in result["traces"]:
            assert trace == cell.collectives
    for rank in runs[2]["ranks"]:
        assert rank["trace"] == cell.collectives


def test_placed_world_trains_as_the_unplaced_one(runs):
    placed = runs[2]
    assert placed["placement"]["perm"] != [0, 1, 2, 3]
    got = [h["loss"] for h in placed["history"]]
    assert [h["step"] for h in placed["history"]] == [1, 2, 3]
    np.testing.assert_allclose(got, runs[1][0]["losses"], rtol=1e-6)
    assert placed["final_loss"] == got[-1]


def test_train_placement_equals_the_reference(runs):
    """``train(placement="psa")``: the gain and permutation of the
    reference's ring C of the same cell on the same service budgets."""
    info = runs[2]["placement"]
    want = runs[0]["4x1"]["ring"]
    assert info["algorithm"] == "psa"
    assert info["perm"] == want["perm"]
    gain = (want["cost_before"] - want["cost_after"]) / want["cost_before"]
    assert info["gain"] == pytest.approx(gain, rel=0, abs=1e-6)
    assert info["gain"] == pytest.approx(1 / 3, rel=0, abs=1e-6)
    assert info["cost_after"] < info["cost_before"]


def test_train_returns_the_whole_parameters(runs):
    params = runs[2]["params"]
    cfg = dpw.config()
    shapes = [tuple(p.shape) for p in tree_flatten(
        Model(cfg, device="cpu").abstract())[0]]
    got = tree_flatten(params)[0]
    assert [tuple(p.shape) for p in got] == shapes
    assert all(p.device.type == "cpu" and torch.isfinite(p).all()
               for p in got)


def test_placed_world_checkpoints_and_resumes(runs):
    """A world's checkpoint holds its whole parameters (rank 0 writes the
    gathered shards); resumed from step 2 the world takes step 3 as the
    uninterrupted world did, to the same bits."""
    from repro_torch.train import checkpoint as ckpt
    placed, resumed = runs[2], runs[3]
    mgr = ckpt.CheckpointManager(placed["checkpoint_dir"])
    assert mgr.all_steps() == [2, 3]
    cfg = dpw.config()
    model = Model(cfg, device="cpu")
    like = {"params": model.abstract(), "opt": opt_lib.abstract_state(
        opt_lib.OptConfig(lr=dpw.LR), model.abstract())}
    saved = mgr.restore(3, like)
    for a, b in zip(tree_flatten(saved["params"])[0],
                    tree_flatten(placed["params"])[0]):
        assert torch.equal(a, b)
    assert int(saved["opt"].step) == 3
    assert [h["step"] for h in resumed["history"]] == [3]
    assert resumed["history"][0]["loss"] == placed["history"][-1]["loss"]
    for a, b in zip(tree_flatten(resumed["params"])[0],
                    tree_flatten(placed["params"])[0]):
        assert torch.equal(a, b)
