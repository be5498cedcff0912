"""The port's mapper_throughput, sparse_scale, kernel_micro and run
against the reference harness on the CPU: the dry runs' objectives and
per-level orders equal the reference's, kernel_micro's inputs are the
reference's draws, and the outputs go where they are pointed (here
``tmp_path``)."""
import json

import jax
import jax.numpy as jnp
import numpy as np

from _torch_serve import one_torch_thread  # noqa: F401
from test_torch_bench_common import (port_common, redirect_get, run_ref_main,
                                     set_budget)
from benchmarks import mapper_throughput as ref_mt
from benchmarks import sparse_scale as ref_ss
from benchmarks_torch import fig5_solvers, kernel_micro
from benchmarks_torch import mapper_throughput as port_mt
from benchmarks_torch import run as port_run
from benchmarks_torch import sparse_scale as port_ss
from repro.core import annealing as ref_annealing


def test_mapper_throughput_dry_run_matches_reference(tmp_path):
    out = port_mt.main(["--dry-run", "--device", "cpu",
                        "--json", str(tmp_path / "t.json")])
    # The reference's dry run: the same instances, keys and budget.
    insts = [ref_mt.random_instance(8, 100 + i) for i in range(2)]
    Cs, Ms, nvs = ref_mt.pad_batch(insts, 8)
    ks = jnp.stack([jax.random.PRNGKey(i) for i in range(2)])
    cfg = ref_annealing.SAConfig(max_neighbors=4, iters_per_exchange=2,
                                 num_exchanges=2, solvers=2)
    _, want, _ = ref_annealing.run_psa_batch(Cs, Ms, ks, cfg, 2, n_valid=nvs)
    assert out["objectives"] == np.asarray(want).tolist()
    saved = json.loads((tmp_path / "t.json").read_text())["throughput"]
    assert saved["config"]["device"] == "cpu"
    assert saved["batched_mappings_per_s"] > 0


def test_sparse_scale_dry_run_matches_reference(tmp_path, monkeypatch):
    ref_json = tmp_path / "ref.json"
    run_ref_main(ref_ss, ["--dry-run", "--json", str(ref_json)], monkeypatch)
    ref = json.loads(ref_json.read_text())["sparse_scale"]
    port = port_ss.main(["--dry-run", "--device", "cpu",
                         "--json", str(tmp_path / "port.json")])
    for got, want in zip(port["eval"], ref["eval"]):
        for key in ("n", "nnz", "density", "max_degree", "perms", "pairs"):
            assert got[key] == want[key], key
    assert len(port["multilevel"]) == len(ref["multilevel"]) == 1
    got, want = port["multilevel"][0], ref["multilevel"][0]
    for key in ("objective", "optimum", "coarse_objective", "quality",
                "baseline_identity", "levels"):
        assert got[key] == want[key], key
    assert [lv["n"] for lv in got["levels"]] == [32, 64]


def test_kernel_micro_rows(tmp_path, monkeypatch):
    """At small shapes on the CPU (the plain versions): the reference's
    row names, one JSON section per kernel, every rate positive."""
    monkeypatch.setattr(kernel_micro, "SHAPES", ((27, 16), (45, 16)))
    path = tmp_path / "k.json"
    rows = kernel_micro.run(str(path), "cpu")
    names = [r.split(",")[0] for r in rows]
    assert names == [f"kernel.{k}.n={n}.{x}" for n in (27, 45)
                     for k, x in (("objective", "b=16"), ("delta", "k=256"),
                                  ("sa_step", "chains=16"),
                                  ("ga_step", "islands=4"))]
    payload = json.loads(path.read_text())["kernel_micro"]
    assert payload["config"] == {"device": "cpu", "device_name": "cpu"}
    for kernel in ("objective", "delta", "sa_step", "ga_step"):
        for entry in payload[kernel].values():
            assert entry["candidate_evals_per_s"] > 0


def test_kernel_micro_inputs_are_the_references():
    """The permutations, swap pairs and chain keys kernel_micro builds
    from keys 0-3 are the reference's jax.random draws."""
    from repro.core import qap as ref_qap
    from repro_torch.core import keys, qap
    n = 45
    np.testing.assert_array_equal(
        qap.random_permutations(keys.prng_key(0), 16, n).numpy(),
        np.asarray(ref_qap.random_permutations(jax.random.PRNGKey(0), 16, n)))
    np.testing.assert_array_equal(
        qap.random_swap_pairs(keys.prng_key(1), 256, n).numpy(),
        np.asarray(ref_qap.random_swap_pairs(jax.random.PRNGKey(1), 256, n)))
    np.testing.assert_array_equal(
        keys.split(keys.prng_key(2), 16).numpy(),
        np.asarray(jax.random.key_data(jax.random.split(
            jax.random.PRNGKey(2), 16))).astype(np.int64))


def test_run_prints_rows_and_reports_failure(monkeypatch, capsys):
    set_budget(monkeypatch, 1e-4)
    redirect_get(monkeypatch)
    monkeypatch.setattr(port_common, "DEVICE", "cpu")
    monkeypatch.setattr("sys.argv", ["run", "fig5"])
    assert port_run.main() == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert [line.split(",")[0] for line in out[1:5]] == [
        f"fig5.solvers={s}" for s in (8, 27, 64, 125)]
    assert out[5].startswith("# fig5 done in")

    def broken(device=None):
        raise RuntimeError("boom")

    monkeypatch.setattr(fig5_solvers, "run", broken)
    assert port_run.main() == 1
    assert "fig5.ERROR,0,failed" in capsys.readouterr().out


def test_solver_hotloop_dry_runs(tmp_path):
    """The port's solver_hotloop (which needs ``annealing.init_chain``) in
    both modes and with ``--loop fused`` on the CPU: every pair of loops
    agreed bit for bit (asserted inside), and the reference's sections
    and keys come out."""
    from benchmarks_torch import solver_hotloop
    path = tmp_path / "h.json"
    argv = ["--dry-run", "--device", "cpu", "--json", str(path)]
    out = solver_hotloop.main(argv)
    assert set(out) == {"solver_hotloop", "ga_hotloop"}
    solver_hotloop.main(argv + ["--loop", "fused"])
    saved = json.loads(path.read_text())
    sa, ga, fused = (saved[k] for k in ("solver_hotloop", "ga_hotloop",
                                        "fused"))
    assert set(sa) == {"config", "sequential_depth", "per_step", "solve"}
    step = sa["per_step"]["n=16"]
    assert {"scan", "event", "speedup_event_vs_scan_hot",
            "speedup_event_vs_scan_annealed"} <= set(step)
    assert sa["solve"]["n=16"]["event"]["maps_per_s"] > 0
    assert set(ga) == {"config", "solve", "solve_batch"}
    assert ga["solve"]["n=16"]["wide"]["offspring_evals_per_s"] > 0
    # max_success 3 + ceil(10 candidates / the CPU's width 6)
    assert fused["sa"]["n=16"]["dispatches_per_temperature_step"] == \
        {"fused": 1, "event": 5}
    assert fused["ga"]["n=16"]["fused"]["rounds_per_s"] > 0
    assert sa["config"]["device_name"] == "cpu"


def test_mesh_shape_dry_runs_match_unsharded(tmp_path):
    """``--mesh-shape 4`` on the CPU (4 emulated devices): mapper_throughput
    asserts sharded == batched inside and writes ``throughput_mesh``;
    scheduler_sim's replay writes ``scheduler_rm_mesh`` with the
    unsharded replay's decisions and objectives."""
    path = tmp_path / "m.json"
    out = port_mt.main(["--dry-run", "--device", "cpu", "--mesh-shape", "4",
                        "--json", str(path)])
    plain = port_mt.main(["--dry-run", "--device", "cpu", "--json", ""])
    assert out["objectives"] == plain["objectives"]
    saved = json.loads(path.read_text())["throughput_mesh"]
    assert saved["config"]["mesh_shape"] == 4 and saved["sharded_s"] > 0
    from benchmarks_torch import scheduler_sim
    argv = ["--dry-run", "--device", "cpu", "--json", ""]
    mesh = scheduler_sim.main(argv + ["--mesh-shape", "4"])
    base = scheduler_sim.main(argv)
    got, want = mesh["scheduler_rm_mesh"], base["scheduler_rm"]
    assert got["config"]["mesh_shape"] == 4
    for path_ in ("first_fit", "co_opt"):
        for key in ("makespan_s", "mean_objective", "backfilled"):
            assert got[path_][key] == want[path_][key], (path_, key)
