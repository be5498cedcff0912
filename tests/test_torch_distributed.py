"""The port's parallel algorithms over devices against the reference's:
``run_psa_mesh`` (the event loop and ``loop="fused"``), ``run_pga_mesh``
(``eval="wide"`` and ``"fused"``), ``run_pca_mesh`` and
``find_mapping(mesh=)`` on ``make_taie(12)`` at the budgets of
``tests/test_distributed.py``, at gloo world sizes 4 and 1 on the CPU,
equal the reference's ``shard_map`` programs at 4 and 1 emulated host
devices bit for bit, on every rank.

The reference runs in one subprocess (its device count is fixed when JAX
starts) and each of the port's worlds is spawned once, all at the same
time; every case reads their results."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch.world import default_backend, run_world

import _torch_world

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300

REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from repro.core import (annealing, composite, distributed, genetic,
                            instances, mapping)

    order, pca_generations, cases, world_cases, out = json.loads(sys.argv[1])
    inst = instances.make_taie(order)
    C, M = jax.numpy.asarray(inst.C), jax.numpy.asarray(inst.M)
    arrays = {}
    for world, names in world_cases.items():
        mesh = Mesh(np.asarray(jax.devices()[:int(world)]), ("proc",))
        for name in names:
            kind, kw, seed = cases[name]
            key = jax.random.PRNGKey(seed)
            if kind == "psa":
                res = distributed.run_psa_mesh(
                    C, M, key, annealing.SAConfig(**kw), mesh)
            elif kind == "pga":
                res = distributed.run_pga_mesh(
                    C, M, key, genetic.GAConfig(**kw), mesh)
            elif kind == "pca":
                res = distributed.run_pca_mesh(
                    C, M, key, composite.CompositeConfig(
                        sa=annealing.SAConfig(**kw),
                        ga=genetic.GAConfig(generations=pca_generations)),
                    mesh)
            else:
                algorithm = kind.split("-")[1]
                sa = annealing.SAConfig(**kw) if algorithm != "pga" else None
                ga = None if algorithm == "psa" else genetic.GAConfig(
                    **(kw if algorithm == "pga" else
                       dict(generations=pca_generations)))
                r = mapping.find_mapping(inst.C, inst.M, algorithm, key=key,
                                         sa_cfg=sa, ga_cfg=ga, mesh=mesh)
                res = (r.perm, np.float32(r.objective))
            for field, value in zip(("perm", "f", "hist"), res):
                arrays[f"{world}/{name}/{field}"] = np.asarray(value)
    np.savez(out, **arrays)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(reference, port)``: the reference's arrays by
    ``"world/case/field"``, and each port world's per-rank results."""
    out = tmp_path_factory.mktemp("distributed") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    ref_cases = {w: sorted({_torch_world.REFERENCE_CASE.get(c, c)
                            for c in cases})
                 for w, cases in _torch_world.WORLD_CASES.items()}
    arg = json.dumps([_torch_world.ORDER, _torch_world.PCA_GENERATIONS,
                      _torch_world.CASES, ref_cases, str(out)])
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, arg], env=env,
                           cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        port = {w: run_world(_torch_world.all_cases, w,
                                 device_type="cpu", timeout_s=TIMEOUT_S)
                for w in _torch_world.WORLD_CASES}
        _, err = ref.communicate(timeout=TIMEOUT_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-4000:]
    with np.load(out) as f:
        reference = dict(f)
    return reference, port


@pytest.mark.parametrize("world,case", [
    (w, c) for w, cases in _torch_world.WORLD_CASES.items() for c in cases])
def test_every_rank_equals_the_reference(runs, world, case):
    reference, port = runs
    ranks = port[world]
    assert len(ranks) == world
    want = f"{world}/{_torch_world.REFERENCE_CASE.get(case, case)}"
    for rank, result in enumerate(ranks):
        perm, f, hist = result[case]
        assert perm.tobytes() == \
            reference[f"{want}/perm"].astype(perm.dtype).tobytes(), \
            (rank, perm, reference[f"{want}/perm"])
        assert np.float32(f).tobytes() == \
            reference[f"{want}/f"].astype(np.float32).tobytes()
        if hist is not None:
            assert hist.tobytes() == \
                reference[f"{want}/hist"].astype(np.float32).tobytes()
    # f = F(perm), and the history does not increase
    from repro_torch.core import instances
    inst = instances.make_taie(_torch_world.ORDER)
    perm, f, hist = ranks[0][case]
    assert sorted(perm.tolist()) == list(range(_torch_world.ORDER))
    assert float(f) == float((inst.C * inst.M[np.ix_(perm, perm)]).sum())
    if hist is not None:
        assert (np.diff(hist) <= 0).all()


def test_a_failing_rank_fails_the_world():
    with pytest.raises(RuntimeError, match="mesh has no axis 'nope'"):
        run_world(_torch_world.bad_axis, 2, device_type="cpu",
                  timeout_s=TIMEOUT_S)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a CUDA card")
def test_a_world_runs_on_cuda_unless_asked_for_the_cpu():
    """No card and no ``device_type``: the world raises before it spawns
    a rank, rather than falling back to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        run_world(_torch_world.bad_axis, 2, timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("device_type,world_size,cards,want", [
    ("cpu", 1, 0, "gloo"), ("cpu", 4, 8, "gloo"), ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 4, "nccl"), ("cuda", 4, 1, "gloo")])
def test_default_backend(monkeypatch, device_type, world_size, cards, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert default_backend(device_type, world_size) == want
