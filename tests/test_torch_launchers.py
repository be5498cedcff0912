"""The launchers that lower production cells, against the reference's:
``topology.opcost`` (the port's count of a step's FLOPs and HBM bytes,
in place of ``hlocost`` over compiled HLO) on small functions and on the
three branches that compute nothing on ``meta``; a lowered SMOKE step's
FLOPs against the reference's HLO count; ``launch.roofline``,
``launch.dryrun``, ``launch.placement_bench``, ``launch.inspect_cell``
and ``benchmarks_torch.placement_gain``.

The reference's ``dryrun``, ``inspect_cell`` and ``placement_bench`` set
``XLA_FLAGS`` to 512 devices when imported, so they are not imported
here: their numpy bodies are recomputed from ``repro.topology.tpu`` and
``repro.parallel.sharding`` (``tests/test_torch_api.py`` holds their
names to the port's by ``ast``)."""
import dataclasses
import functools
import json
import math
import time

import numpy as np
import pytest
import jax
import torch
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.launch import roofline as ref_roofline
from repro.models.api import Model as JModel, input_specs as jinput_specs
from repro.models.config import LM_SHAPES as J_LM_SHAPES
from repro.models.config import ShapeCell as JCell
from repro.parallel import sharding as jsh
from repro.topology import hlocost as ref_hlocost
from repro.topology import tpu as ref_tpu
from repro.train import optimizer as jopt
from repro.train.step import make_prefill_step, make_train_step
from repro_torch import configs
from repro_torch.kernels.selective_scan import SelectiveScan
from repro_torch.launch import (dryrun, inspect_cell, lowering,
                                placement_bench, roofline)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import layers, rwkv
from repro_torch.models.config import ShapeCell
from repro_torch.parallel import sharding as sh
from repro_torch.topology import h100, opcost
from benchmarks_torch import placement_gain

from _torch_serve import one_torch_thread  # noqa: F401

F32 = 4


# --------------------------------------------------------------- opcost
def test_counts_an_mm_exactly():
    a, b = torch.ones(3, 5), torch.ones(5, 7)
    with opcost.count_costs() as cost:
        a @ b
    assert cost.flops == 2 * 3 * 5 * 7
    assert cost.flops_by_dtype == {"f32": 2 * 3 * 5 * 7}
    assert cost.hbm_bytes == F32 * (3 * 5 + 5 * 7 + 3 * 7)
    assert list(cost.by_op) == [("mm", "(3, 5),(5, 7)")]


def test_counts_a_bmm_forward_and_backward():
    """Both passes: the forward bmm and the backward's two, each 2 B M N
    K; the backward's seed (ones_like) and nothing else."""
    x = torch.ones(2, 3, 4, requires_grad=True)
    y = torch.ones(2, 4, 5, dtype=torch.float32, requires_grad=True)
    with opcost.count_costs() as cost:
        out = torch.bmm(x, y)
        out.sum().backward()
    flops = 2 * 2 * 3 * 4 * 5
    assert cost.flops == 3 * flops
    bmm = F32 * (2 * 3 * 4 + 2 * 4 * 5 + 2 * 3 * 5)
    # sum reads out and writes a scalar; ones_like writes the seed (its
    # input's shape alone is read); the seed's expand is a view
    assert cost.hbm_bytes == 3 * bmm + F32 * (2 * 3 * 5 + 1) + F32
    assert sorted(name for name, _ in cost.by_op) == \
        ["bmm", "bmm", "bmm", "ones_like", "sum"]


def test_views_are_free_and_an_add_is_three_tensors():
    x = torch.ones(4, 6)
    with opcost.count_costs() as cost:
        v = x.view(6, 4).t().transpose(0, 1)[1:].unsqueeze(0).expand(2, 5, 4)
        x.detach()
        torch.empty_like(x)
    assert cost.hbm_bytes == 0 and cost.flops == 0 and not cost.by_op
    with opcost.count_costs() as cost:
        v + v
    assert cost.hbm_bytes == F32 * 3 * 2 * 5 * 4 and cost.flops == 0


def test_nested_counters_and_collectives():
    """An inner counter's ops reach the outer one once; a reported
    collective counts under collective_bytes, not hbm_bytes."""
    from repro_torch.topology.traffic import CollectiveOp
    op = CollectiveOp("all-reduce", 1024, [[0, 1, 2, 3]])
    with opcost.count_costs() as outer:
        with opcost.count_costs() as inner:
            torch.ones(8) * 2
            opcost.add_collective(op)
    assert outer.hbm_bytes == inner.hbm_bytes == F32 * 8 * 3
    assert outer.collectives == inner.collectives == [op]
    assert outer.collective_bytes == 2 * 1024 * 3 // 4 * 4
    assert not opcost.active()


# ------------------------------------------- the shapes-alone branches
def _count(fn):
    with opcost.count_costs() as cost:
        out = fn()
    return cost, out


def _passes(fn, inputs, grads_of):
    """Counted forward and backward of ``fn`` on ``inputs``; the backward
    seeds (made outside the counter) for the outputs ``grads_of``."""
    fwd, outs = _count(lambda: fn(*inputs))
    outs = outs if isinstance(outs, tuple) else (outs,)
    seeds = [torch.ones_like(outs[i]) for i in grads_of]
    want = [x for x in inputs if isinstance(x, torch.Tensor)
            and x.requires_grad]
    bwd, _ = _count(lambda: torch.autograd.grad(
        [outs[i] for i in grads_of], want, seeds))
    return fwd, bwd


def _on_meta(inputs):
    return [x.detach().to("meta").requires_grad_(x.requires_grad)
            if isinstance(x, torch.Tensor) else x for x in inputs]


def _same_work(fn, inputs, grads_of):
    """The real CPU computation's counted work equals the meta branch's
    report, forward and backward: FLOPs and bytes exactly."""
    cpu = _passes(fn, inputs, grads_of)
    meta = _passes(fn, _on_meta(inputs), grads_of)
    for (c, m), what in zip(zip(cpu, meta), ("forward", "backward")):
        assert m.flops == c.flops, what
        assert m.flops_by_dtype == c.flops_by_dtype, what
        assert m.hbm_bytes == c.hbm_bytes, what
        assert m.hbm_bytes > 0
    return cpu


def _randn(shape, seed, dtype=torch.float32, grad=True):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype).requires_grad_(grad)


@pytest.mark.parametrize("arch,b,s,window", [
    ("qwen3_4b", 2, 32, None),        # 2 x 2 chunk pairs, bf16 in and out
    ("gemma3_4b", 1, 48, 20),         # a sliding window, one sequence
    ("qwen3_4b", 3, 40, None),        # padded to 48: 3 x 3 pairs
])
def test_attention_reports_its_work(arch, b, s, window):
    """``_mea``'s ``_MEAShapes``: every chunk pair's products and
    elementwise ops, masked pairs included."""
    cfg = configs.smoke_config(arch)
    dt = cfg.compute_dtype
    q = _randn((b, s, cfg.num_heads, cfg.head_dim), 0, dt)
    k = _randn((b, s, cfg.num_kv_heads, cfg.head_dim), 1, dt)
    v = _randn((b, s, cfg.num_kv_heads, cfg.head_dim), 2, dt)
    pos = torch.arange(s)
    fwd, bwd = _same_work(
        lambda *x: layers._mea(*x, pos, pos, cfg, window), (q, k, v), (0,))
    pairs = math.ceil(s / cfg.attn_q_chunk) * math.ceil(s / cfg.attn_kv_chunk)
    one = 2 * b * cfg.num_heads * cfg.attn_q_chunk * cfg.attn_kv_chunk * \
        cfg.head_dim
    assert fwd.flops == 2 * one * pairs and bwd.flops == 4 * one * pairs


@pytest.mark.parametrize("b,s,h_grad", [(2, 32, False), (1, 16, True),
                                        (3, 24, False)])
def test_mamba_scan_reports_its_work(b, s, h_grad):
    """``SelectiveScan``'s meta branch at Jamba's SMOKE widths: the plain
    scan's forward, and its backward's recompute and gradient, with and
    without a gradient of ``h_last``; no matrix product."""
    cfg = configs.smoke_config("jamba_v0_1_52b")
    d, n = cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
    ins = (_randn((b, s, d), 0), _randn((b, s, d), 1).abs(),
           -_randn((d, n), 2).abs().detach().requires_grad_(),
           _randn((b, s, n), 3), _randn((b, s, n), 4))
    fwd, bwd = _same_work(SelectiveScan.apply, ins,
                          (0, 1) if h_grad else (0,))
    assert fwd.flops == bwd.flops == 0


@pytest.mark.parametrize("b,s,s_grad", [(2, 16, False), (1, 64, True),
                                        (2, 128, False)])
def test_wkv_reports_its_work(b, s, s_grad):
    """``_WKVShapes`` at RWKV6's SMOKE widths (chunks of 64: one or two),
    ``s0`` without a gradient as in training."""
    cfg = configs.smoke_config("rwkv6_7b")
    hd = cfg.rwkv_head_size
    h = cfg.d_model // hd
    ins = [_randn((b, s, h, hd), i) for i in range(4)]
    ins[3] = torch.sigmoid(ins[3]).detach().requires_grad_()
    ins += [_randn((h, hd), 5), _randn((b, h, hd, hd), 6, grad=False)]
    fwd, bwd = _same_work(rwkv._wkv_scan, ins, (0, 1) if s_grad else (0,))
    assert fwd.flops == 2 * b * s * h * hd * hd == bwd.flops / 2


# --------------------------------------- a lowered step against the HLO
# (arch, kind) -> the reference's HLO FLOPs over the port's, measured
# on the CPU: the same products, but for the reference Mamba scan's
# y = einsum("bcdn,bcn->bcd", states, c), a dot in its HLO that the
# port's plain scan (and K8) computes elementwise -- 7 Mamba layers of
# 8, once in a forward and three times in a train step (forward and the
# dot's two gradients)
MEASURED_RATIO = {("qwen3_4b", "train"): 1.0, ("qwen3_4b", "prefill"): 1.0,
                  ("jamba_v0_1_52b", "train"): 0.99624,
                  ("jamba_v0_1_52b", "prefill"): 0.99488}


@pytest.mark.parametrize("arch,kind", sorted(MEASURED_RATIO))
def test_lowered_smoke_flops_match_the_reference_hlo(arch, kind):
    seq, batch = 32, (4 if kind == "train" else 2)
    jcfg = jconfigs.smoke_config(arch)
    jmodel = JModel(jcfg)
    cell = JCell(kind, seq, batch, kind)
    aparams = jmodel.abstract()
    if kind == "train":
        ocfg = jopt.OptConfig(moment_dtype=jcfg.opt_dtype)
        step = make_train_step(jmodel, ocfg, jopt.warmup_cosine(3e-4, 1, 3),
                               num_groups=1)
        lowered = jax.jit(step).lower(aparams, jopt.abstract_state(
            ocfg, aparams), jinput_specs(jcfg, cell))
    else:
        lowered = jax.jit(make_prefill_step(jmodel, num_groups=1)).lower(
            aparams, jinput_specs(jcfg, cell))
    want = ref_hlocost.analyze(lowered.compile().as_text(), 1).flops
    mesh = Mesh(np.arange(1, dtype=object).reshape(1, 1), ("data", "model"))
    got = lowering.lower_cell(configs.smoke_config(arch),
                              ShapeCell(kind, seq, batch, kind), mesh,
                              costs=True).cost.flops
    ratio = got / want
    assert ratio == pytest.approx(MEASURED_RATIO[arch, kind], rel=0.1)
    assert ratio == pytest.approx(MEASURED_RATIO[arch, kind], abs=1e-5)
    cfg = configs.smoke_config(arch)
    mamba = cfg.layer_pattern.count("m") + cfg.layer_pattern.count("M")
    dots = 2 * batch * seq * cfg.mamba_expand * cfg.d_model * \
        cfg.mamba_d_state * mamba * (3 if kind == "train" else 1)
    assert want - got == dots


def test_lowering_counts_only_when_asked():
    cfg = configs.smoke_config("qwen3_4b")
    mesh = Mesh(np.arange(4, dtype=object).reshape(2, 2), ("data", "model"))
    cell = ShapeCell("train", 32, 4, "train")
    plain = lowering.lower_cell(cfg, cell, mesh)
    counted = lowering.lower_cell(cfg, cell, mesh, costs=True)
    assert plain.cost is None
    assert counted.cost.collectives == counted.collectives
    assert [(o.kind, o.bytes, o.groups) for o in counted.collectives] == \
        [(o.kind, o.bytes, o.groups) for o in plain.collectives]
    assert counted.cost.flops > 0 and counted.cost.hbm_bytes > 0


# ------------------------------------------------------------ roofline
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_model_flops_match_reference(arch):
    assert roofline.active_params(arch) == ref_roofline.active_params(arch)
    for cell in J_LM_SHAPES:
        assert roofline.model_flops(arch, cell.name) == \
            ref_roofline.model_flops(arch, cell.name)


def test_derive_reference_record_at_h100_rates():
    """tests/test_roofline.py's record, read as bf16, at the H100's
    rates: the terms by hand."""
    rec = {"status": "ok", "num_devices": 256, "arch": "qwen3_4b",
           "shape": "train_4k", "mesh": "single",
           "flops_hlo": 197e12, "hbm_bytes": 819e9 * 2,
           "collective_bytes": 256 * 50e9 * 0.5}
    d = roofline.derive(rec)
    assert d["compute_s"] == pytest.approx(197e12 / 989.4e12)
    assert d["memory_s"] == pytest.approx(2 * 819e9 / 3.35e12)
    assert d["collective_s"] == pytest.approx(256 * 25e9 / (256 * 450e9))
    assert d["dominant"] == "memory"
    mf = ref_roofline.model_flops("qwen3_4b", "train_4k")
    assert d["useful_ratio"] == pytest.approx(mf / (197e12 * 256))
    assert d["roofline_fraction"] == pytest.approx(
        (mf / (256 * 989.4e12)) / d["memory_s"])
    split = dict(rec, flops_by_dtype={"bf16": 98.94e12, "f32": 6.7e12})
    assert roofline.derive(split)["compute_s"] == pytest.approx(0.2)
    assert roofline.derive(dict(rec, status="skipped")) is None
    assert (h100.HBM_BW, h100.NVLINK_BW) == (3.35e12, 450e9)
    assert h100.PEAK_FLOPS == {"bf16": 989.4e12, "f16": 989.4e12,
                               "f32": 67e12}


def test_load_all_and_table(tmp_path, monkeypatch):
    ok = {"status": "ok", "num_devices": 256, "arch": "granite_34b",
          "shape": "decode_32k", "mesh": "single", "flops_hlo": 1e12,
          "flops_by_dtype": {"bf16": 1e12}, "hbm_bytes": 3.35e10,
          "collective_bytes": 0.0, "weight_bytes_per_device": 1e9,
          "cache_bytes_per_device": 2.35e9, "tag": ""}
    for name, rec in (("a", ok), ("b", dict(ok, mesh="multi")),
                      ("c", {"status": "skipped", "mesh": "single"})):
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    monkeypatch.setattr(roofline, "ART", str(tmp_path))
    rows = roofline.load_all("single")
    assert len(rows) == 1 and rows[0]["dominant"] == "memory"
    assert rows[0]["roofline_fraction"] == pytest.approx(0.1)
    table = roofline.markdown_table(rows)
    assert "| granite_34b | decode_32k | single |" in table
    assert "**memory**" in table


# -------------------------------------------------------------- dryrun
def _ref_sharded_bytes(tree, spec_tree, sizes):
    """The reference dry run's ``_sharded_bytes_per_device`` body."""
    total = 0
    specs = jax.tree.leaves(spec_tree, is_leaf=lambda x: isinstance(x, JP))
    for leaf, spec in zip(jax.tree.leaves(tree), specs):
        shards = 1
        for entry in spec:
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                shards *= sizes[a]
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // max(shards, 1)
    return total


def test_dryrun_qwen3_train_at_production_width():
    """Qwen3-4B train_4k at full width and all 36 layers on (16, 16):
    the weight and optimizer bytes a device holds are the reference's
    arithmetic; the counted work is that of a whole step."""
    rec = dryrun.lower_cell("qwen3_4b", "train_4k", False)
    jcfg = jconfigs.get_config("qwen3_4b")
    jmodel = JModel(jcfg)
    aparams = jmodel.abstract()
    pspecs = jsh.resolve_tree(jmodel.specs(), jsh.SINGLE_POD_RULES)
    ocfg = jopt.OptConfig(moment_dtype=jcfg.opt_dtype)
    aopt, ospecs = jopt.abstract_state(ocfg, aparams), \
        jopt.state_specs(ocfg, pspecs)
    sizes = {"data": 16, "model": 16}
    assert rec["status"] == "ok" and rec["num_devices"] == 256
    assert rec["num_params"] == jmodel.num_params()
    assert rec["weight_bytes_per_device"] == \
        _ref_sharded_bytes(aparams, pspecs, sizes)
    assert rec["opt_bytes_per_device"] == \
        _ref_sharded_bytes(aopt.mu, ospecs.mu, sizes) + \
        _ref_sharded_bytes(aopt.nu, ospecs.nu, sizes)
    assert rec["flops"] == rec["flops_hlo"] == sum(
        rec["flops_by_dtype"].values())
    assert set(rec["flops_by_dtype"]) == {"bf16", "f32"}
    assert rec["hbm_bytes"] > rec["weight_bytes_per_device"]
    assert set(rec["collectives"]) == {"all-gather", "reduce-scatter",
                                       "all-reduce"}
    assert rec["collective_bytes"] > 0
    assert 0.2 < roofline.derive(rec)["useful_ratio"] <= 1.0
    assert not {"compile_s", "cost_raw", "memory_analysis"} & set(rec)


def test_dryrun_skips_long_500k_on_full_attention():
    rec = dryrun.lower_cell("qwen3_4b", "long_500k", False)
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]


def test_dryrun_decode_cache_bytes_and_rules(tmp_path):
    """A decode cell's cache bytes are lowering's; fsdp= replicates the
    weights; a rule the port's layouts cannot take raises naming it,
    and run() records it as an error."""
    rec = dryrun.lower_cell("granite_34b", "decode_32k", False,
                            overrides={"num_layers": 2,
                                       "layer_pattern": "TT"})
    assert rec["cache_bytes_per_device"] == 738_197_504 * 2 // 88
    whole = dryrun.lower_cell("granite_34b", "decode_32k", False,
                              overrides={"num_layers": 2,
                                         "layer_pattern": "TT"},
                              rule_overrides={"fsdp": None})
    assert whole["weight_bytes_per_device"] > rec["weight_bytes_per_device"]
    assert "all-gather" not in whole["collectives"] or \
        whole["collectives"]["all-gather"]["bytes"] < \
        rec["collectives"]["all-gather"]["bytes"]
    # tp off the model axis; fsdp over data alone on two pods (replicated
    # over pod); a logical axis the port does not have
    for name, value, multi in (("tp", None, False), ("fsdp", ("data",), True),
                               ("bogus", ("data",), False)):
        with pytest.raises(ValueError, match=f"rule {name}="):
            dryrun.lower_cell("qwen3_4b", "train_4k", multi,
                              rule_overrides={name: value})
    dryrun.run(["qwen3_4b"], ["long_500k"], [False],
               rule_overrides={"tp": None}, out_dir=str(tmp_path))
    dryrun.run(["qwen3_4b"], ["decode_32k"], [False],
               overrides={"num_layers": 1, "layer_pattern": "T"},
               rule_overrides={"seq": None}, out_dir=str(tmp_path))
    saved = {p.name: json.loads(p.read_text()) for p in tmp_path.iterdir()}
    assert saved["qwen3_4b.long_500k.single.json"]["status"] == "skipped"
    err = saved["qwen3_4b.decode_32k.single.json"]
    assert err["status"] == "error" and "rule seq=" in err["traceback"]


def test_parse_overrides_and_rules():
    assert dryrun._parse_overrides(["num_layers=2", "remat=full",
                                    "attn_dp=true"]) == \
        {"num_layers": 2, "remat": "full", "attn_dp": True}
    assert dryrun._parse_rules(["fsdp=", "batch=pod+data"]) == \
        {"fsdp": None, "batch": ("pod", "data")}
    mesh = Mesh(np.arange(8, dtype=object).reshape(2, 2, 2),
                ("pod", "data", "model"))
    sh.check_rules(mesh, {"fsdp": ("pod", "data"), "batch": ("pod", "data"),
                          "tp": "model"})


# ----------------------------------------------------- placement_bench
@pytest.mark.parametrize("ndev", [256, 512])
def test_fragmented_system_graph_is_the_reference_body(ndev):
    spec = ref_tpu.PodSpec(num_pods=max(4, (ndev * 2 + 255) // 256))
    m_full = ref_tpu.distance_matrix(spec)
    rng = np.random.default_rng(0)
    alloc = np.sort(rng.choice(spec.num_chips, size=ndev, replace=False))
    want = m_full[np.ix_(alloc, alloc)]
    got = placement_bench._fragmented_system_graph(ndev)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert not np.array_equal(placement_bench._fragmented_system_graph(
        ndev, seed=1), want)


@pytest.fixture
def small_cells(monkeypatch):
    """The launchers at a CPU test's size: every arch its SMOKE config,
    every cell 16 sequences of 64 positions and the production mesh
    (pod, data, model) = (2, 4, 2)."""
    from repro_torch.models.config import shape_cell
    monkeypatch.setattr(configs, "get_config", configs.smoke_config)
    monkeypatch.setattr(placement_bench, "shape_cell", lambda name: (
        dataclasses.replace(shape_cell(name), seq_len=64, global_batch=16)))
    monkeypatch.setattr(placement_bench, "make_production_mesh",
                        lambda multi_pod=False: Mesh(np.arange(
                            16 if multi_pod else 8, dtype=object).reshape(
                            (2, 4, 2) if multi_pod else (4, 2)),
                            ("pod", "data", "model") if multi_pod
                            else ("data", "model")))


def test_bench_end_to_end_on_the_cpu(small_cells, tmp_path, monkeypatch):
    """placement_bench.bench on the CPU in under 60 s (the service's
    budgets cut to the tests' small ones): psa, pga and pca on the
    pristine torus and the fragmented allocation, none worse than the
    identity, a gain on the fragmented one; placement_gain reads the
    artifact into six rows."""
    from repro_torch.core import annealing, genetic
    from repro_torch.launch import placement as pl
    monkeypatch.setattr(pl, "PlacementService", functools.partial(
        pl.PlacementService, num_processes=2,
        sa_cfg=annealing.SAConfig(max_neighbors=6, iters_per_exchange=4,
                                  num_exchanges=2, solvers=2,
                                  seed_with="identity"),
        ga_cfg=genetic.GAConfig(generations=5, pop_size=8,
                                seed_identity=True)))
    t = time.perf_counter()
    rec = placement_bench.bench("gemma3_4b", "train_4k", True, device="cpu")
    assert time.perf_counter() - t < 60
    assert rec["num_devices"] == 16 and rec["traffic_nonzero"] > 0
    for scen in ("algorithms", "fragmented"):
        assert set(rec[scen]) == {"psa", "pga", "pca"}
        for a in rec[scen].values():
            assert a["cost_after"] <= a["cost_before"]
    assert max(a["gain"] for a in rec["fragmented"].values()) > 0
    out = tmp_path / "placement"
    out.mkdir()
    (out / "gemma3_4b.train_4k.multi.json").write_text(json.dumps(rec))
    monkeypatch.setattr(placement_gain, "ART", str(out))
    rows = placement_gain.run()
    assert [r.split(",")[0] for r in rows] == [
        f"placement.gemma3_4b.train_4k.{label}.{algo}"
        for label in ("pristine", "frag") for algo in ("psa", "pga", "pca")]
    assert all(";gain=" in r for r in rows)


def test_placement_gain_without_artifacts(tmp_path, monkeypatch):
    monkeypatch.setattr(placement_gain, "ART", str(tmp_path))
    monkeypatch.setattr(placement_gain.common, "DEVICE", "cpu")
    monkeypatch.setattr(placement_bench, "_run", lambda *a, **k: None)
    rows = placement_gain.run()
    assert rows[0].startswith("placement.unavailable,")


def test_inspect_cell_prints_top_contributors(small_cells, capsys,
                                               monkeypatch):
    monkeypatch.setattr("sys.argv", ["inspect_cell", "--arch", "granite_34b",
                                     "--shape", "decode_32k", "--top", "5"])
    inspect_cell.main()
    out = capsys.readouterr().out.splitlines()
    hbm = out.index("== top HBM traffic (bytes x calls) ==")
    coll = out.index("== top collectives (result bytes x count) ==")
    assert coll - hbm - 1 == 5 and 0 < len(out) - coll - 1 <= 5
    assert any("all-gather" in line for line in out[coll:])


def test_top_contributors_orders_by_bytes(capsys):
    from repro_torch.topology.traffic import CollectiveOp
    cost = opcost.OpCost(by_op={("mm", "(2, 2)"): [3, 48.0, 48.0],
                                ("add", "(8,)"): [1, 96.0, 0.0]})
    ops = [CollectiveOp("all-gather", 10, [[0, 1]])] * 3 + \
        [CollectiveOp("all-reduce", 40, [[0, 1, 2, 3]])]
    inspect_cell.top_contributors(cost, ops, 1)
    out = capsys.readouterr().out.splitlines()
    assert out[1].split()[:3] == ["96", "x1", "add"]
    assert out[3].split()[:3] == ["40", "x1", "all-reduce"]
