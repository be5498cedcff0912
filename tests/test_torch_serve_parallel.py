"""Serving over the (data, model) mesh, the port against the reference:
Qwen3, Granite (MQA), Gemma3 (a 32-token ring cache, decoded past its
window across two ranks' slices), Jamba (16 experts, over ``ep``) and
RWKV6 at SMOKE width in f32 on (data, model) meshes (2, 2) and (1, 4)
of 4 gloo ranks on the CPU, and Jamba with a capped expert capacity on
(2, 2).  Each rank runs
``data_parallel.make_serve_steps``: a prefill of 4 x 44 prompts into a
52-position cache sharded over ``seq`` (Mamba's channels and RWKV's
heads over ``tp``), then 5 greedy decode steps with the flash-decoding
combine.  The logits of every step, the caches reassembled from the
ranks' parts and the greedy tokens are held against the reference's
jitted prefill (``Model.prefill`` with the cache length, as
``make_prefill_step`` runs it) and ``make_decode_step`` on the same mesh
shape with ``cache_specs`` shardings (8 emulated host devices, one
subprocess, the port's weights and prompts) and against the port's one
device; the live traces against ``lowering.lower_cell``'s; the program
graph C of Granite's decode against XLA's by what it costs the
placements; then Granite-34B and Qwen3-MoE-235B ``decode_32k`` at full
width and depth lowered on the production (16, 16) mesh, and
``check_mesh`` on every configuration's serving cells."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from repro.topology import hlocost as ref_hlocost
from repro.topology import traffic as ref_traffic
from repro_torch import configs
from repro_torch.core import annealing, genetic
from repro_torch.launch import lowering, placement as pl
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.world import run_world
from repro_torch.models.api import Model
from repro_torch.models.config import ShapeCell, shape_cell
from repro_torch.models.param import tree_flatten
from repro_torch.parallel import sharding as sh
from repro_torch.topology import tpu

import _torch_serve_world as sw
import _torch_tp_world as tpw
from _torch_serve import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600
TOL = 1e-5
SHAPES = {"2x2": (2, 2), "1x4": (1, 4)}
MODELS = {"qwen3": ("qwen3_4b", {}), "granite": ("granite_34b", {}),
          "gemma3": ("gemma3_4b", {}),
          "jamba": ("jamba_v0_1_52b", dict(num_experts=16)),
          "rwkv": ("rwkv6_7b", {})}
# name -> (arch, config overrides, (data, model) shape)
CASES = {f"{m}-{s}": (arch, overrides, shape)
         for m, (arch, overrides) in MODELS.items()
         for s, shape in SHAPES.items()}
# a capped capacity on a data axis of 2: decode routes the global batch
# as one group (a rank's rows alone would keep tokens the reference drops)
CASES["jamba_capped-2x2"] = ("jamba_v0_1_52b", dict(
    num_experts=16, moe_capacity_factor=1.25), (2, 2))
NAMES = sorted(CASES)
COMPILED = ("granite-1x4", "granite-2x2")     # XLA's decode C read
SMALL_SA = dict(max_neighbors=10, iters_per_exchange=8, num_exchanges=4,
                solvers=4, seed_with="identity")
SMALL_GA = dict(generations=15, pop_size=12, seed_identity=True)
RING_KINDS = ("all-gather", "all-reduce", "reduce-scatter")

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
    from repro.models.api import Model
    from repro.parallel import sharding as sh
    from repro.topology import hlocost, tpu, traffic
    from repro.train.step import make_decode_step

    (cases, prompt_len, cache_len, steps, inputs, compiled, small_sa,
     small_ga, ring_kinds, out) = json.loads(sys.argv[1])

    def named(mesh, tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                            is_leaf=lambda x: isinstance(x, P))

    hlo = {}
    for name, (arch, overrides, shape) in cases.items():
        cfg = configs.smoke_config(arch).with_overrides(
            compute_dtype=jnp.float32, **overrides)
        model = Model(cfg)
        data = np.load(inputs[name])
        treedef = jax.tree.structure(model.abstract())
        params = jax.tree.unflatten(treedef, [
            jnp.asarray(data[f"p{i}"]) for i in range(treedef.num_leaves)])
        n = int(np.prod(shape))
        mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))
        rules = sh.rules_for_mesh(mesh)
        with sh.use_rules(rules), activate_mesh(mesh):
            psh = named(mesh, sh.resolve_tree(model.specs(), rules))
            csh = named(mesh, sh.resolve_tree(model.cache_specs(), rules))
            bsh = {"tokens": NamedSharding(mesh, sh.resolve_spec(
                P("batch", None), rules))}
            lsh = NamedSharding(mesh, sh.resolve_spec(P("batch", "tp"),
                                                      rules))
            prefill = jax.jit(
                lambda p, b: model.prefill(p, b, shape[0], cache_len),
                in_shardings=(psh, bsh), out_shardings=(lsh, csh))
            decode = jax.jit(make_decode_step(model), in_shardings=(
                psh, csh, bsh, NamedSharding(mesh, P())),
                out_shardings=(lsh, csh))
            logits, cache = prefill(params, {"tokens": jnp.asarray(
                data["tokens"])})
            saved = {f"c{i}": np.asarray(c)
                     for i, c in enumerate(jax.tree.leaves(cache))}
            saved["l0"] = np.asarray(logits)
            tok = jnp.argmax(logits, axis=-1)
            toks = [np.asarray(tok)]
            for t in range(steps):
                batch = {"tokens": tok[:, None]}
                pos = jnp.int32(prompt_len + t)
                if t == 0 and name in compiled:
                    text = decode.lower(params, cache, batch,
                                        pos).compile().as_text()
                logits, cache = decode(params, cache, batch, pos)
                saved[f"l{t + 1}"] = np.asarray(logits)
                tok = jnp.argmax(logits, axis=-1)
                toks.append(np.asarray(tok))
            saved["tokens"] = np.stack(toks, axis=1)
        np.savez(f"{out}.{name}.npz", **saved)
        if name not in compiled:
            continue
        c = np.zeros((n, n), np.float64)
        for op in hlocost.analyze(text, n).collective_ops:
            if op.kind in ring_kinds:
                c += traffic.traffic_matrix([op], n).astype(np.float64)
        pl.reset_default_service()
        pl._SERVICE = pl.PlacementService(
            sa_cfg=annealing.SAConfig(**small_sa),
            ga_cfg=genetic.GAConfig(**small_ga))
        res = pl.solve_placement(c.astype(np.float32), tpu.distance_matrix(
            tpu.spec_for_mesh_shape(tuple(shape))), "psa")
        hlo[name] = {"text": text, "perm": [int(x) for x in res.perm],
                     "cost_before": float(res.cost_before),
                     "cost_after": float(res.cost_after)}
    with open(out, "w") as f:
        json.dump(hlo, f)
""")


def _err(got, want):
    """The largest difference over ``want``'s largest magnitude."""
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _logical_mesh(shape):
    return Mesh(np.arange(int(np.prod(shape)), dtype=object).reshape(shape),
                tpw.AXES)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference, ranks, ties)``: the reference's logits, caches and
    tokens by case and its compiled decodes; every rank's
    ``_torch_serve_world.serve_rank`` of all the cases, in one world, by
    case; and each rank's ``argmax_ties`` by mesh name."""
    tmp = tmp_path_factory.mktemp("serve_parallel")
    inputs = {}
    for name, (arch, overrides, _) in CASES.items():
        cfg = sw.config(arch, overrides)
        leaves = tree_flatten(sw.numpy_weights(arch, overrides))[0]
        inputs[name] = str(tmp / f"{name}.npz")
        np.savez(inputs[name], tokens=sw.prompt(cfg),
                 **{f"p{i}": p for i, p in enumerate(leaves)})
    out = tmp / "reference.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    arg = json.dumps([CASES, sw.PROMPT, sw.CACHE_LEN, sw.STEPS, inputs,
                      COMPILED, SMALL_SA, SMALL_GA, RING_KINDS, str(out)])
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, arg], env=env,
                           cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_world(sw.serve_rank, 4, device_type="cpu",
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
            reference[name] = {
                "logits": [data[f"l{t}"] for t in range(sw.STEPS + 1)],
                "cache": [data[f"c{i}"] for i in range(sum(
                    k.startswith("c") for k in data.files))],
                "tokens": data["tokens"]}
    by_case = {name: [rank[i] for rank in ranks]
               for i, name in enumerate(NAMES)}
    ties = {s: [rank[len(NAMES) + i] for rank in ranks]
            for i, s in enumerate(sorted(SHAPES.values()))}
    return reference, by_case, ties


@pytest.fixture(scope="module")
def one_device():
    return {name: sw.one_device(arch, overrides, groups=shape[0])
            for name, (arch, overrides, shape) in CASES.items()}


@pytest.fixture(scope="module")
def lowered():
    """Each case's prefill and decode cells lowered on its mesh."""
    pcell, dcell = sw.cells()
    out = {}
    for name, (arch, overrides, shape) in CASES.items():
        cfg = sw.config(arch, overrides)
        mesh = _logical_mesh(shape)
        out[name] = (lowering.lower_cell(cfg, pcell, mesh),
                     lowering.lower_cell(cfg, dcell, mesh))
    return out


@pytest.fixture(autouse=True)
def fresh_port_service():
    pl.reset_default_service()
    yield
    pl.reset_default_service()


# ------------------------------------------------------------ the worlds

@pytest.mark.parametrize("name", NAMES)
def test_logits_equal_the_reference_and_one_device(runs, one_device, name):
    """The prefill's and each decode step's logits, whole (every rank's
    columns of the vocabulary, every data rank's rows)."""
    want = one_device[name]["logits"]
    ref = runs[0][name]["logits"]
    assert len(want) == len(ref) == sw.STEPS + 1
    for t, (w, r) in enumerate(zip(want, ref)):
        assert _err(w, r) < TOL, (t, _err(w, r))
    for rank, result in enumerate(runs[1][name]):
        for t, (g, w, r) in enumerate(zip(result["logits"], want, ref)):
            assert g.shape == w.shape == r.shape
            assert _err(g, r) < TOL, (rank, t, _err(g, r))
            assert _err(g, w) < TOL, (rank, t, _err(g, w))


@pytest.mark.parametrize("name", NAMES)
def test_greedy_tokens_equal_the_reference_and_one_device(runs, one_device,
                                                          name):
    want = one_device[name]["tokens"]
    assert want.shape == (sw.BATCH, sw.STEPS + 1)
    np.testing.assert_array_equal(runs[0][name]["tokens"], want)
    for result in runs[1][name]:
        np.testing.assert_array_equal(result["tokens"], want)


@pytest.mark.parametrize("name", NAMES)
def test_rank_caches_reassemble_the_whole_cache(runs, one_device, name):
    """The prefill's cache from every rank's part (positions over
    ``seq``, Mamba channels and RWKV heads over ``tp``, rows over
    data) against the reference's and one device's whole cache."""
    want = one_device[name]["cache"]
    ref = runs[0][name]["cache"]
    assert len(want) == len(ref) > 0
    for rank, result in enumerate(runs[1][name]):
        assert len(result["cache"]) == len(want)
        for i, (g, w, r) in enumerate(zip(result["cache"], want, ref)):
            assert g.shape == w.shape == r.shape, (i, g.shape, w.shape)
            assert _err(g, r) < TOL, (rank, i, _err(g, r))
            assert _err(g, w) < TOL, (rank, i, _err(g, w))


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_its_part_of_the_cache(runs, name):
    """A rank's KV caches hold ``Sc / m`` positions (a windowed layer's
    ring ``window / m``), its Mamba state ``d_inner / m`` channels and
    its RWKV state ``H / m`` heads, on ``B / d`` rows: each dim its
    cache spec names ``seq`` or ``tp`` over ``m``, ``batch`` over
    ``d``."""
    arch, overrides, (d, m) = CASES[name]
    model = Model(sw.config(arch, overrides), device="meta")
    whole = tree_flatten(model.abstract_cache(sw.BATCH, sw.CACHE_LEN))[0]
    specs = tree_flatten(model.cache_specs())[0]
    split = {"batch": d, "seq": m, "tp": m, None: 1}
    want = [tuple(n // split[e] for n, e in zip(leaf.shape, spec))
            for leaf, spec in zip(whole, specs)]
    assert {e for spec in specs for e in spec} - {None, "batch"}, specs
    for result in runs[1][name]:
        assert result["cache_shapes"] == want


@pytest.mark.parametrize("name", NAMES)
def test_live_traces_are_the_lowered_traces(runs, lowered, name):
    """Prefill's and every decode step's collectives on every rank are
    ``lower_cell``'s of the prefill and decode cells."""
    pre, dec = lowered[name]
    assert pre.kind == "prefill" and dec.kind == "decode"
    assert len(pre.collectives) > 0 and len(dec.collectives) > 0
    for result in runs[1][name]:
        assert result["prefill_trace"] == pre.collectives
        for trace in result["decode_traces"]:
            assert trace == dec.collectives


def test_k8_runs_on_the_cpu_as_its_plain_version(runs):
    """Jamba's prefill runs the scan on a rank's ``d_inner / m``
    channels: the plain scan on the CPU (no launch counted; the card's
    world counts K8's, ``tests/test_torch_cuda.py``)."""
    for name in NAMES:
        for result in runs[1][name]:
            assert result["k8"] == 0


@pytest.mark.parametrize("shape", sorted(SHAPES.values()))
def test_greedy_token_is_the_whole_vocabularys_first_argmax(runs, shape):
    for tokens, whole in runs[2][shape]:
        np.testing.assert_array_equal(tokens, np.argmax(whole, axis=-1))
        assert tokens.tolist() == [5, whole.shape[1] - 3, 0]


# ----------------------------------------------- the placement of decode

def _small_service():
    return pl.PlacementService(sa_cfg=annealing.SAConfig(**SMALL_SA),
                               ga_cfg=genetic.GAConfig(**SMALL_GA),
                               device="cpu")


@pytest.mark.parametrize("name", COMPILED)
def test_decode_traffic_places_against_the_reference(runs, lowered, name):
    """C of the port's lowered decode and of XLA's compiled one (its ring
    collectives): the placements, each priced under the reference's C,
    and the two gains, pinned; the two C's at unit sum pinned apart."""
    shape = CASES[name][2]
    n = int(np.prod(shape))
    m = tpu.distance_matrix(tpu.spec_for_mesh_shape(shape))
    c_ref = np.zeros((n, n), np.float64)
    for op in ref_hlocost.analyze(runs[0]["hlo"][name]["text"],
                                  n).collective_ops:
        if op.kind in RING_KINDS:
            c_ref += ref_traffic.traffic_matrix([op], n).astype(np.float64)
    c_port = pl.traffic_from_compiled(lowered[name][1], n).astype(np.float64)
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


# On (1, 4) the model group is a ring of 4 on the 2 x 2 torus: both
# packages' C are the same at unit sum and both choose the order (3, 1,
# 0, 2), gain 1/3.  On (2, 2) the torus joins every pair of groups, so
# the mesh's own order is optimal in both; XLA's ops are not the port's
# op for op, and its C at unit sum lies a little apart (pinned).
PINNED = {"granite-2x2": dict(port_gain=0.0, ref_gain=0.0, cost_ratio=1.0,
                              unit_gap=0.001918200194678),
          "granite-1x4": dict(port_gain=1 / 3, ref_gain=1 / 3,
                              cost_ratio=1.0, unit_gap=0.0)}


# ----------------------------------------------- the production mesh

GRANITE_DECODE_OPS = {("data", "all-gather"): 8,
                      ("model", "all-gather"): 264,
                      ("model", "all-reduce"): 353}


def _by_axis(cell, shape):
    ids = np.arange(int(np.prod(shape))).reshape(shape)
    axes = {"model": ids.tolist(), "data": ids.T.tolist()}
    counts = {}
    for op in cell.collectives:
        axis = next(a for a, g in axes.items() if op.groups == g)
        counts[axis, op.kind] = counts.get((axis, op.kind), 0) + 1
    return counts


def test_granite_decode_32k_at_full_width_and_depth_on_16x16():
    """Granite-34B (88 layers, one kv head) ``decode_32k`` on (16, 16):
    a device's bf16 KV caches are its 8 sequences' 2048 of 32768
    positions, 738,197,504 bytes; per layer q, k and v gathered over
    ``model``, the combine's max and sums, and *g* after ``wo`` and the
    MLP."""
    cell = lowering.lower_cell(configs.get_config("granite_34b"),
                               shape_cell("decode_32k"),
                               _logical_mesh((16, 16)))
    assert cell.kind == "decode" and cell.num_devices == 256
    assert cell.cache_bytes_per_device == 738_197_504
    assert _by_axis(cell, (16, 16)) == GRANITE_DECODE_OPS


# the 10 parameter gathers over data and, at its capped capacity, each
# of the 94 MoE layers' input gathered over data to route the global
# batch as one group
QWEN3_MOE_DECODE_OPS = {("data", "all-gather"): 104,
                        ("model", "all-gather"): 282,
                        ("model", "all-reduce"): 377}


def test_qwen3_moe_decode_32k_cache_bytes_on_16x16():
    cell = lowering.lower_cell(configs.get_config("qwen3_moe_235b_a22b"),
                               shape_cell("decode_32k"),
                               _logical_mesh((16, 16)))
    assert cell.cache_bytes_per_device == 3_154_116_608
    assert _by_axis(cell, (16, 16)) == QWEN3_MOE_DECODE_OPS


@pytest.mark.parametrize("batch,gathers", [(4, 1), (1, 0)])
def test_a_capped_moe_decode_routes_the_global_batch(batch, gathers):
    """Jamba SMOKE on (2, 2) at a capped capacity: decode gathers each
    MoE layer's input over data where the ranks hold different rows,
    and not where every rank holds the whole batch; dropless, never."""
    from repro_torch.models.transformer import MOE_CHARS
    mesh = _logical_mesh((2, 2))
    cell = ShapeCell("decode", 64, batch, "decode")
    counts = [_by_axis(lowering.lower_cell(sw.config(
        "jamba_v0_1_52b", dict(moe_capacity_factor=f)), cell, mesh),
        (2, 2))[("data", "all-gather")] for f in (0.0, 1.25)]
    cfg = sw.config("jamba_v0_1_52b", {})
    moe_layers = sum(ch in MOE_CHARS for ch in cfg.layer_pattern)
    assert moe_layers > 0
    assert counts[1] - counts[0] == gathers * moe_layers


@pytest.mark.parametrize("cell", ("prefill_32k", "decode_32k"))
@pytest.mark.parametrize("arch", sorted(configs.all_configs()))
def test_every_configuration_serves_on_the_production_mesh(arch, cell):
    sh.check_mesh(_logical_mesh((16, 16)), configs.get_config(arch),
                  shape_cell(cell))


@pytest.mark.parametrize("cfg_kw,seq", [({}, 1000),
                                        (dict(local_window=24), 4096)])
def test_a_cache_that_does_not_split_whole_raises(cfg_kw, seq):
    """1000 positions, or Gemma3's ring of 24, on a model axis of 16."""
    cfg = configs.get_config("gemma3_4b").with_overrides(**cfg_kw)
    mesh = _logical_mesh((16, 16))
    for kind in ("prefill", "decode"):
        cell = ShapeCell(kind, seq, 16, kind)
        with pytest.raises(ValueError, match="does not split whole"):
            sh.check_mesh(mesh, cfg, cell)
        with pytest.raises(ValueError, match="does not split whole"):
            lowering.lower_cell(cfg, cell, mesh)
    sh.check_mesh(mesh, cfg, ShapeCell("train", seq, 16, "train"))


def test_lower_cell_of_a_train_cell_is_lower_train_cell():
    cfg = tpw.config("qwen3_4b")
    mesh = _logical_mesh((2, 2))
    got = lowering.lower_cell(cfg, tpw.CELL, mesh)
    want = lowering.lower_train_cell(cfg, tpw.CELL, mesh)
    assert got.kind == want.kind == "train"
    assert got.cache_bytes_per_device == 0
    assert got.collectives == want.collectives


def test_a_batch_that_does_not_split_over_data_is_replicated():
    """``long_500k``'s rule at a SMOKE size: one sequence on a data axis
    of 2 is every data rank's whole batch, and a device's cache is the
    whole cache over the model axis alone (the reference's
    ``rules["batch"] = None``)."""
    import torch
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import data_parallel as dp
    cfg = sw.config("jamba_v0_1_52b", {})
    cell = ShapeCell("decode", 64, 1, "decode")
    lowered = lowering.lower_cell(cfg, cell, _logical_mesh((2, 2)))
    whole = tree_flatten(Model(cfg, device="meta").abstract_cache(1, 64))[0]
    assert lowered.cache_bytes_per_device == sum(
        c.numel() * c.element_size() for c in whole) // 2
    axis = dp.data_axis(coll.MetaMesh((2, 2), tpw.AXES))
    tokens = torch.zeros((1, 1), dtype=torch.int32)
    assert dp.shard_batch(cfg, cell, {"tokens": tokens},
                          axis)["tokens"].shape == (1, 1)
