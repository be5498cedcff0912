"""The port's instance mesh and mesh-sharded dispatch against the
reference's, on the CPU: ``run_*_batch_sharded`` over 1 and 4 emulated
devices equal the reference's unsharded ``run_*_batch`` bit for bit
(the reference's contract, ``tests/test_batch_sharded.py``), with mixed
``n_valid``, warm and cold ``init_perm`` rows and a wave that does not
divide the mesh; the padding helpers and errors are the reference's; and
``MappingEngine(mesh=)``, a thread ``EngineFleet(meshes=)`` and the
placement service's mesh equal the reference's unsharded engine."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import annealing as jann
from repro.core import batch_sharded as ref_bs
from repro.core import composite as jcomp
from repro.core import genetic as jgen
from repro.launch.mesh import make_instance_mesh as ref_instance_mesh
from repro.serve import MappingEngine as RefEngine
from repro.serve import MapRequest as RefRequest
from repro_torch import convert
from repro_torch.core import batch_sharded
from repro_torch.launch import placement
from repro_torch.launch.mesh import (Mesh, make_instance_mesh,
                                     make_local_mesh, make_mesh_with_devices)
from repro_torch.serve import EngineFleet, MappingEngine, MapRequest

from _fixtures import (GA_SMALL, PCA_SMALL, SA_SMALL, instance,
                       padded_batch)
from _torch_serve import one_torch_thread  # noqa: F401

SIZES = [6, 8, 8, 5, 7]           # 5 rows: pads to 8 over 4 devices
REF_RUN = {"psa": (jann.run_psa_batch, SA_SMALL),
           "pga": (jgen.run_pga_batch, GA_SMALL),
           "pca": (jcomp.run_pca_batch, PCA_SMALL)}
PORT_RUN = {"psa": (batch_sharded.run_psa_batch_sharded,
                    convert.sa_config_from_reference),
            "pga": (batch_sharded.run_pga_batch_sharded,
                    convert.ga_config_from_reference),
            "pca": (batch_sharded.run_pca_batch_sharded,
                    convert.composite_config_from_reference)}


def _wave():
    """The reference test's wave plus warm starts on rows 0 and 3 (the
    other rows cold: a -1 first entry)."""
    Cs, Ms, nvs, keys = padded_batch(SIZES, bucket=8)
    ips = np.full((len(SIZES), 8), -1, np.int32)
    for i in (0, 3):
        n = SIZES[i]
        ips[i, :n] = np.roll(np.arange(n), 1)
        ips[i, n:] = np.arange(n, 8)
    return Cs, Ms, nvs, keys, ips


@pytest.fixture(scope="module")
def reference_waves():
    """Each solver's unsharded reference solve of the wave."""
    Cs, Ms, nvs, keys, ips = _wave()
    out = {}
    for kind, (run, cfg) in REF_RUN.items():
        p, f, h = run(Cs, Ms, keys, cfg, 2, n_valid=nvs,
                      init_perm=jnp.asarray(ips))
        out[kind] = (np.asarray(p), np.asarray(f), np.asarray(h))
    return out


@pytest.mark.parametrize("nshard", [1, 4])
@pytest.mark.parametrize("kind", ["psa", "pga", "pca"])
def test_sharded_matches_reference_unsharded(kind, nshard, reference_waves):
    Cs, Ms, nvs, keys, ips = _wave()
    run, to_port = PORT_RUN[kind]
    cfg = to_port(dataclasses.asdict(REF_RUN[kind][1]))
    p, f, h = run(np.asarray(Cs), np.asarray(Ms), np.asarray(keys), cfg, 2,
                  n_valid=np.asarray(nvs), init_perm=ips,
                  mesh=make_instance_mesh(nshard, device="cpu"))
    want_p, want_f, want_h = reference_waves[kind]
    assert p.shape[0] == f.shape[0] == h.shape[0] == len(SIZES)
    assert f.numpy().tobytes() == want_f.tobytes()
    np.testing.assert_array_equal(p.numpy(), want_p)
    assert h.numpy().tobytes() == want_h.tobytes()


def test_round_up_to_multiple_matches_reference():
    for b in range(1, 12):
        for m in range(1, 6):
            assert batch_sharded.round_up_to_multiple(b, m) == \
                ref_bs.round_up_to_multiple(b, m)
    for mod in (batch_sharded, ref_bs):
        with pytest.raises(ValueError, match="multiple must be >= 1, got 0"):
            mod.round_up_to_multiple(3, 0)


def test_pad_to_mesh_multiple_matches_reference():
    Cs, Ms, nvs, keys = padded_batch([6, 8, 5], bucket=8)
    ips = np.full((3, 8), -1, np.int32)
    ips[1] = np.arange(8)[::-1]
    want = ref_bs.pad_to_mesh_multiple(Cs, Ms, keys, nvs, jnp.asarray(ips),
                                       multiple=4)
    got = batch_sharded.pad_to_mesh_multiple(
        np.asarray(Cs), np.asarray(Ms), np.asarray(keys), np.asarray(nvs),
        ips, multiple=4)
    assert got[-1] == want[-1] == 3
    for g, w in zip(got[:-1], want[:-1]):
        assert g.shape[0] == 4
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the dummy row replicates instance 0, warm-start row included
    np.testing.assert_array_equal(got[4][3].numpy(), ips[0])
    assert int(got[3][3]) == 6


def test_pad_to_mesh_multiple_noop_and_optional_args():
    Cs, Ms, _, keys = padded_batch([8, 8], bucket=8)
    Cs, Ms, keys = (torch.as_tensor(np.array(a)) for a in (Cs, Ms, keys))
    pCs, pMs, pkeys, pnvs, pips, B = batch_sharded.pad_to_mesh_multiple(
        Cs, Ms, keys, None, None, multiple=2)
    assert B == 2 and pCs is Cs and pnvs is None and pips is None
    pCs, _, _, pnvs, pips, B = batch_sharded.pad_to_mesh_multiple(
        Cs, Ms, keys, None, None, multiple=3)
    assert B == 2 and pCs.shape[0] == 3 and pnvs is None and pips is None
    for mod, empty in ((batch_sharded, Cs[:0]), (ref_bs, jnp.zeros((0, 8)))):
        with pytest.raises(ValueError, match="empty instance batch"):
            mod.pad_to_mesh_multiple(empty, empty, empty, None, None,
                                     multiple=2)


def test_unknown_axis_raises_the_references_error():
    Cs, Ms, nvs, keys = padded_batch([8], bucket=8)
    with pytest.raises(ValueError) as want:
        ref_bs.run_psa_batch_sharded(Cs, Ms, keys, SA_SMALL, 2, n_valid=nvs,
                                     mesh=ref_instance_mesh(1), axis="nope")
    with pytest.raises(ValueError) as got:
        batch_sharded.run_psa_batch_sharded(
            np.asarray(Cs), np.asarray(Ms), np.asarray(keys),
            convert.sa_config_from_reference(dataclasses.asdict(SA_SMALL)),
            2, n_valid=np.asarray(nvs),
            mesh=make_instance_mesh(1, device="cpu"), axis="nope")
    assert str(got.value) == str(want.value)


def test_instance_mesh_on_the_cpu():
    mesh = make_instance_mesh(4, device="cpu")
    assert isinstance(mesh, Mesh) and mesh.size == 4
    assert list(mesh.shape.items()) == [("instances", 4)]
    assert mesh.axis_names == ("instances",)
    assert list(mesh.devices) == [torch.device("cpu")] * 4
    assert make_instance_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match="num_devices"):
        make_instance_mesh(0, device="cpu")
    grid = make_mesh_with_devices(["cpu"] * 6, (2, 3), ("a", "b"))
    assert list(grid.shape.items()) == [("a", 2), ("b", 3)]
    assert grid.devices.shape == (2, 3)
    local = make_local_mesh(device="cpu")
    assert list(local.shape.items()) == [("data", 1), ("model", 1)]
    with pytest.raises(ValueError):
        Mesh(np.asarray(["cpu"] * 2, dtype=object), ("a", "b"))


def _engine_requests(cls, seed0):
    """The reference test's request stream (shared M: the second round
    warm-starts from the first round's shape cache)."""
    M_shared = instance(8, 99)[1]
    reqs = []
    for i in range(5):
        C, _ = instance(6 + (i % 2) * 2, seed0 + i)
        n = C.shape[0]
        reqs.append(cls(job_id=f"j{seed0 + i}", C=C, M=M_shared[:n, :n],
                        seed=i))
    return reqs


def _drive(engine, cls):
    out = {}
    for seed0 in (40, 60):
        reqs = _engine_requests(cls, seed0)
        for r in reqs:
            engine.submit(r)
        out.update(engine.flush())
    return out


@pytest.fixture(scope="module")
def reference_engine_run():
    return _drive(RefEngine(buckets=(8,), num_processes=2, sa_cfg=SA_SMALL,
                            polish_rounds=8), RefRequest)


def _port_sa():
    return convert.sa_config_from_reference(dataclasses.asdict(SA_SMALL))


def _assert_same(got, want):
    assert set(got) == set(want)
    for jid, w in want.items():
        np.testing.assert_array_equal(got[jid].perm, w.perm)
        assert got[jid].objective == w.objective
        assert got[jid].warm_start == w.warm_start


@pytest.mark.parametrize("nshard", [1, 4])
def test_engine_mesh_matches_reference_engine(nshard, reference_engine_run):
    engine = MappingEngine(buckets=(8,), num_processes=2, sa_cfg=_port_sa(),
                           polish_rounds=8,
                           mesh=make_instance_mesh(nshard, device="cpu"))
    assert engine.device == torch.device("cpu")
    got = _drive(engine, MapRequest)
    assert any(r.warm_start for r in got.values())
    _assert_same(got, reference_engine_run)


def test_engine_rejects_mesh_without_axis_and_foreign_device():
    with pytest.raises(ValueError) as want:
        RefEngine(mesh=ref_instance_mesh(1, axis="other"))
    with pytest.raises(ValueError) as got:
        MappingEngine(mesh=make_instance_mesh(1, axis="other", device="cpu"))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="first device"):
        MappingEngine(mesh=make_instance_mesh(2, device="cpu"),
                      device="meta")


def test_fleet_meshes_match_reference_engine():
    """Thread workers get the meshes round-robin (4 and 1 devices); every
    response equals the reference's engine with warm starts off."""
    reqs = _engine_requests(MapRequest, 40)
    fleet = EngineFleet(workers=2, buckets=(8,), num_processes=2,
                        sa_cfg=_port_sa(), polish_rounds=8, max_batch=2,
                        meshes=[make_instance_mesh(4, device="cpu"),
                                make_instance_mesh(1, device="cpu")],
                        device="cpu")
    try:
        futs = [fleet.submit(r) for r in reqs]
        fleet.flush()
        got = {r.job_id: f.result(timeout=60) for r, f in zip(reqs, futs)}
        sizes = sorted(w.engine.mesh.size for w in fleet.workers)
    finally:
        fleet.stop()
    assert sizes == [1, 4]
    ref = RefEngine(buckets=(8,), num_processes=2, sa_cfg=SA_SMALL,
                    polish_rounds=8, max_batch=2, warm_start=False)
    for r in _engine_requests(RefRequest, 40):
        ref.submit(r)
    _assert_same(got, ref.flush())


def test_placement_configure_engine_mesh():
    """A service configured with a 4-device mesh (the default service's
    engine is on the card; here a small-budget one on the CPU) equals
    the reference's unsharded service; a reset restores the unsharded
    engine."""
    from repro.launch import placement as ref_placement
    small = dict(num_processes=2, sa_cfg=SA_SMALL, ga_cfg=GA_SMALL)
    placement._SERVICE = placement.PlacementService(
        device="cpu", num_processes=2, sa_cfg=_port_sa(),
        ga_cfg=convert.ga_config_from_reference(
            dataclasses.asdict(GA_SMALL)))
    placement.configure_engine_mesh(make_instance_mesh(4, device="cpu"))
    try:
        eng = placement.get_engine()
        assert eng.mesh is not None and eng.mesh.size == 4
        C, M = instance(6, 3)
        ref = ref_placement.PlacementService(**small)
        for algorithm in ("psa", "pga"):     # pga warm-starts from psa
            res = placement.solve_placement(C, M, algorithm)
            want = ref.solve(C, M, algorithm)
            np.testing.assert_array_equal(res.perm, want.perm)
            assert res.cost_after == want.cost_after <= res.cost_before
    finally:
        placement.reset_default_service()
    assert placement._SERVICE is None
    placement._SERVICE = placement.PlacementService(device="cpu")
    try:
        assert placement.get_engine().mesh is None
    finally:
        placement.reset_default_service()
