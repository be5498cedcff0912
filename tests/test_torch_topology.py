"""The port's ``topology`` against the reference's: ``traffic`` (HLO
collective parsing, wire bytes, the program graph C), ``hlocost`` (the
trip-count-aware cost model) and the hop model of ``tpu``, on the same
inputs -- HLO texts the reference lowers at test time on 8 emulated host
devices (in one subprocess: its device count is fixed when JAX starts)
and hand-written lines -- bit for bit."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.topology import hlocost as ref_hlocost
from repro.topology import tpu as ref_tpu
from repro.topology import traffic as ref_traffic
from repro_torch.topology import hlocost, tpu, traffic

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300

REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro import configs
    from repro.core.distributed import shard_map
    from repro.launch.mesh import activate_mesh
    from repro.models.api import Model, batch_partition_specs, input_specs
    from repro.models.config import ShapeCell
    from repro.parallel import sharding as sh
    from repro.train import optimizer as opt_lib
    from repro.train.step import make_train_step

    out = sys.argv[1]
    texts = {}
    devs = np.asarray(jax.devices()[:8])
    line = Mesh(devs, ("i",))
    grid = Mesh(devs.reshape(2, 4), ("x", "y"))
    x8 = jnp.ones((8, 64), jnp.float32)

    def lower(fn, mesh, in_specs, out_specs, *args):
        f = shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
        return jax.jit(f).lower(*args).compile().as_text()

    texts["psum"] = lower(lambda a: jax.lax.psum(a, "i"), line, P("i"),
                          P("i"), x8)
    texts["all_gather"] = lower(
        lambda a: jax.lax.all_gather(a, "i", tiled=True), line, P("i"),
        P(None), x8)
    texts["psum_scatter"] = lower(
        lambda a: jax.lax.psum_scatter(a.reshape(8, 8), "i", tiled=True),
        line, P("i"), P("i"), x8)
    texts["all_to_all"] = lower(
        lambda a: jax.lax.all_to_all(a.reshape(8, 8), "i", 0, 0,
                                     tiled=True), line, P("i"), P("i"), x8)
    texts["ppermute"] = lower(
        lambda a: jax.lax.ppermute(a, "i", [(k, (k + 1) % 8)
                                            for k in range(8)]),
        line, P("i"), P("i"), x8)
    x24 = jnp.ones((2, 4, 32), jnp.bfloat16)
    texts["grid_x"] = lower(lambda a: jax.lax.psum(a, "x"), grid,
                            P("x", "y"), P("x", "y"), x24)
    texts["grid_y"] = lower(lambda a: jax.lax.all_gather(a, "y", tiled=True),
                            grid, P("x", "y"), P("x", None), x24)

    def scanned(a):
        def body(h, _):
            return jax.lax.psum(h, "i") * 0.5, None
        h, _ = jax.lax.scan(body, a, None, length=5)
        return h
    texts["scan_psum"] = lower(scanned, line, P("i"), P("i"), x8)

    # tests/test_roofline.py's scanned 8-layer MLP
    w = jnp.ones((8, 256, 256), jnp.float32)
    x = jnp.ones((64, 256), jnp.float32)

    def mlp(w, x):
        def body(h, wl):
            return h @ wl, None
        h, _ = jax.lax.scan(body, x, w)
        return h.sum()
    texts["scanned_mlp"] = jax.jit(mlp).lower(w, x).compile().as_text()

    # Qwen3's SMOKE train step on a (4, 1) mesh
    cfg = configs.smoke_config("qwen3_4b")
    model = Model(cfg)
    ocfg = opt_lib.OptConfig(moment_dtype=cfg.opt_dtype)
    cell = ShapeCell("train", 32, 8, "train")
    mesh = Mesh(devs[:4].reshape(4, 1), ("data", "model"))
    rules = sh.rules_for_mesh(mesh)
    with sh.use_rules(rules), activate_mesh(mesh):
        tree = lambda t: jax.tree.map(lambda s: NamedSharding(mesh, s), t,
                                      is_leaf=lambda x: isinstance(x, P))
        pspecs = sh.resolve_tree(model.specs(), rules)
        bspecs = sh.resolve_tree(batch_partition_specs(cfg, cell), rules)
        step = jax.jit(make_train_step(model, ocfg,
                                       opt_lib.warmup_cosine(3e-4, 1, 3),
                                       num_groups=4), in_shardings=(
            tree(pspecs), tree(opt_lib.state_specs(ocfg, pspecs)),
            {k: NamedSharding(mesh, v) for k, v in bspecs.items()}))
        aparams = model.abstract()
        texts["qwen3_train"] = step.lower(
            aparams, opt_lib.abstract_state(ocfg, aparams),
            input_specs(cfg, cell)).compile().as_text()
    with open(out, "w") as f:
        json.dump(texts, f)
""")

# text -> the device count its collectives are read at
DEVICES = {"psum": 8, "all_gather": 8, "psum_scatter": 8, "all_to_all": 8,
           "ppermute": 8, "grid_x": 8, "grid_y": 8, "scan_psum": 8,
           "scanned_mlp": 1, "qwen3_train": 4}


@pytest.fixture(scope="module")
def texts(tmp_path_factory):
    out = tmp_path_factory.mktemp("topology") / "hlo.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    done = subprocess.run([sys.executable, "-c", REFERENCE, str(out)],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=TIMEOUT_S)
    assert done.returncode == 0, done.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


def _ops(ops):
    return [(op.kind, op.bytes, op.groups) for op in ops]


@pytest.mark.parametrize("name", sorted(DEVICES))
def test_parse_collectives_equals_reference(texts, name):
    n = DEVICES[name]
    got = traffic.parse_collectives(texts[name], n)
    want = ref_traffic.parse_collectives(texts[name], n)
    assert _ops(got) == _ops(want)
    assert traffic.total_collective_bytes(got) == \
        ref_traffic.total_collective_bytes(want)
    assert traffic.traffic_matrix(got, n).tobytes() == \
        ref_traffic.traffic_matrix(want, n).tobytes()
    for a, b in zip(got, want):
        assert traffic._wire_bytes(a) == ref_traffic._wire_bytes(b)


@pytest.mark.parametrize("name", sorted(DEVICES))
def test_hlocost_equals_reference(texts, name):
    n = DEVICES[name]
    got = hlocost.analyze(texts[name], n)
    want = ref_hlocost.analyze(texts[name], n)
    assert got.flops == want.flops
    assert got.hbm_bytes == want.hbm_bytes
    assert got.collective_bytes == want.collective_bytes
    assert got.by_collective == want.by_collective
    assert _ops(got.collective_ops) == _ops(want.collective_ops)
    mod, ref_mod = hlocost.parse_module(texts[name]), \
        ref_hlocost.parse_module(texts[name])
    assert {k: [(i.name, i.op, i.type_str) for i in c.instructions]
            for k, c in mod.items()} == \
        {k: [(i.name, i.op, i.type_str) for i in c.instructions]
         for k, c in ref_mod.items()}


def test_the_texts_cover_every_collective_and_a_trip_count(texts):
    kinds = {op.kind for name in DEVICES for op in
             traffic.parse_collectives(texts[name], DEVICES[name])}
    assert kinds == set(traffic.COLLECTIVE_KINDS)
    scan = hlocost.analyze(texts["scan_psum"], 8)
    assert scan.by_collective["all-reduce"]["count"] == 5
    mlp = hlocost.analyze(texts["scanned_mlp"], 1)
    assert mlp.flops == pytest.approx(2 * 64 * 256 * 256 * 8, rel=0.05)
    # a grid's collective over one axis: iota groups, transposed for "x"
    x = traffic.parse_collectives(texts["grid_x"], 8)[0]
    assert sorted(map(sorted, x.groups)) == [[0, 4], [1, 5], [2, 6], [3, 7]]


GROUP_LINES = [
    "x = f32[4] all-gather(%y), replica_groups=[2,8]<=[8,2]T(1,0), dims={0}",
    "x = f32[4] all-reduce(%y), replica_groups=[4,2]<=[8], to_apply=%add",
    "x = f32[4] all-reduce(%y), replica_groups=[2,4]<=[2,2,2]T(2,1,0)",
    "x = f32[4] all-reduce(%y), replica_groups={{0,1},{2,3}}, to_apply=%a",
    "x = f32[4] collective-permute(%y), source_target_pairs={{0,1},{1,2}}",
    "x = f32[4] all-reduce(%y), to_apply=%add",
]


@pytest.mark.parametrize("line", GROUP_LINES)
def test_parse_groups_equals_reference(line):
    assert traffic._parse_groups(line, 16) == \
        ref_traffic._parse_groups(line, 16)


@pytest.mark.parametrize("shape", ["f32[128,256]{1,0}", "(bf16[8], s32[])",
                                   "pred[]", "c64[3,3]", "u4[16]",
                                   "(f32[2,2], token[])"])
def test_shape_bytes_equal_reference(shape):
    assert traffic._shape_bytes(shape) == ref_traffic._shape_bytes(shape)
    assert hlocost._type_bytes(shape) == ref_hlocost._type_bytes(shape)


@pytest.mark.parametrize("kind", traffic.COLLECTIVE_KINDS)
@pytest.mark.parametrize("g", [1, 2, 3, 8, 11])
def test_wire_bytes_and_traffic_equal_reference(kind, g):
    groups = [[a, (a + 1) % g] for a in range(g)] \
        if kind == "collective-permute" else [list(range(g))]
    op = traffic.CollectiveOp(kind=kind, bytes=12 * 128, groups=groups)
    ref = ref_traffic.CollectiveOp(kind=kind, bytes=12 * 128, groups=groups)
    assert traffic._wire_bytes(op) == ref_traffic._wire_bytes(ref)
    assert traffic.total_collective_bytes([op]) == \
        ref_traffic.total_collective_bytes([ref])
    assert traffic.traffic_matrix([op], g).tobytes() == \
        ref_traffic.traffic_matrix([ref], g).tobytes()


def test_total_collective_bytes_truncates_as_the_reference():
    """g=11, payload=12: the ring's 15360 wire bytes sum to 15359.99...
    in floating point, and ``int`` truncates them to 15359."""
    op = traffic.CollectiveOp(kind="all-gather", bytes=12 * 128,
                              groups=[list(range(11))])
    ref = ref_traffic.CollectiveOp(kind="all-gather", bytes=12 * 128,
                                   groups=[list(range(11))])
    assert traffic.total_collective_bytes([op]) == 15359 == \
        ref_traffic.total_collective_bytes([ref])
    assert float(traffic.traffic_matrix([op], 11).sum()) == 15360.0


def test_collective_op_fields_equal_reference():
    fields = lambda c: [f.name for f in dataclasses.fields(c)]
    assert fields(traffic.CollectiveOp) == fields(ref_traffic.CollectiveOp)
    assert traffic.COLLECTIVE_KINDS == ref_traffic.COLLECTIVE_KINDS
    assert traffic._DTYPE_BYTES == ref_traffic._DTYPE_BYTES
    assert hlocost._DTYPE_BYTES == ref_hlocost._DTYPE_BYTES


SPECS = [dict(), dict(side_x=4, side_y=4), dict(side_x=2, side_y=2,
                                                num_pods=2),
         dict(side_x=3, side_y=3), dict(side_x=4, side_y=2),
         dict(side_x=2, side_y=2, num_pods=2, dci_penalty=10.0),
         dict(num_pods=2)]


@pytest.mark.parametrize("kw", SPECS, ids=[str(k) for k in SPECS])
def test_distance_matrix_equals_reference(kw):
    got, want = tpu.PodSpec(**kw), ref_tpu.PodSpec(**kw)
    assert (got.num_chips, got.chips_per_pod) == \
        (want.num_chips, want.chips_per_pod)
    assert tpu.distance_matrix(got).tobytes() == \
        ref_tpu.distance_matrix(want).tobytes()
    for chip in range(0, got.num_chips, max(1, got.num_chips // 7)):
        assert tpu.torus_coords(got, chip) == ref_tpu.torus_coords(want, chip)


SHAPES = [(1,), (4, 1), (8, 1), (2, 4, 1), (64, 1), (256, 1), (16, 16),
          (2, 16, 16), (3, 5), (1024,)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_spec_for_mesh_shape_equals_reference(shape):
    assert dataclasses.asdict(tpu.spec_for_mesh_shape(shape)) == \
        dataclasses.asdict(ref_tpu.spec_for_mesh_shape(shape))


def test_the_hop_model_carries_no_tpu_rates():
    assert tpu.DCI_PENALTY == ref_tpu.DCI_PENALTY
    for name in ("ICI_BW", "HBM_BW", "PEAK_FLOPS", "HBM_PER_CHIP"):
        assert hasattr(ref_tpu, name) and not hasattr(tpu, name)
    for a, b in [(0, 3), (3, 0), (1, 15), (7, 8)]:
        assert tpu._torus_dist(a, b, 16) == ref_tpu._torus_dist(a, b, 16)
