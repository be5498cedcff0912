"""The port's scheduler_sim against the reference's on the CPU: the
dry-run replay (synthetic and SWF traces) gives the same virtual-clock
metrics and ``objective_improvement``; the fleet replay under a kill the
same decisions and chaos accounting; the subprocess fleet under SIGKILL
and the legacy stream run to their own checks.  Every JSON goes to
``tmp_path``."""
import dataclasses
import json

import pytest

from _torch_serve import one_torch_thread  # noqa: F401
from test_torch_bench_common import run_ref_main
from benchmarks import scheduler_sim as ref_sched
from benchmarks_torch import scheduler_sim as port_sched
from repro_torch.serve.rm import ReplayReport
from repro_torch.serve.trace import format_swf, synthetic_trace

# Host-clock fields, and the warmup's program count (the reference
# compiles one program per wave size, the port runs one dummy wave per
# bucket): everything else in a replay's report is a decision.
WALLS = {"wall_s", "map_wall_p50_ms", "map_wall_p99_ms", "mapped_jobs_per_s",
         "warmup_s", "recovered_ratio", "recovery_latency_s",
         "first_recovery_s", "warmup_programs"}


def decisions(section):
    """A replay section without its host-clock fields and the config
    keys only one harness has."""
    out = {}
    for key, value in section.items():
        if key in WALLS:
            continue
        if isinstance(value, dict):
            value = {k: v for k, v in value.items()
                     if k not in WALLS and k not in ("device", "mesh_shape")}
        out[key] = value
    return out


def both(argv, tmp_path, monkeypatch):
    """``argv`` through the reference's and the port's ``main``; their
    JSON files."""
    ref_json, port_json = tmp_path / "ref.json", tmp_path / "port.json"
    run_ref_main(ref_sched, argv + ["--json", str(ref_json)], monkeypatch)
    port_sched.main(argv + ["--device", "cpu", "--json", str(port_json)])
    return (json.loads(ref_json.read_text()),
            json.loads(port_json.read_text()))


@pytest.mark.parametrize("trace", ["synthetic", "swf"])
def test_replay_dry_run_matches_reference(trace, tmp_path, monkeypatch):
    argv = ["--dry-run"]
    if trace == "swf":
        path = tmp_path / "trace.swf"
        path.write_text(format_swf(synthetic_trace(
            8, sizes=(6, 8), arrival_rate=100.0, mean_run_s=0.05, seed=3)))
        argv += ["--trace", str(path)]
    ref, port = both(argv, tmp_path, monkeypatch)
    ref, port = ref["scheduler_rm"], port["scheduler_rm"]
    assert decisions(port) == decisions(ref)
    assert port["objective_improvement"] == ref["objective_improvement"]
    assert port["co_opt"]["max_batches_per_wave"] <= 1
    assert port["config"]["device"] == "cpu"


def test_fleet_kill_dry_run_matches_reference(tmp_path, monkeypatch):
    ref, port = both(["--dry-run", "--workers", "2", "--kill-one"], tmp_path,
                     monkeypatch)
    # The replay reports' decisions; requeues, respawns and the shared
    # cache's hits depend on thread timing in either harness.
    report = [f.name for f in dataclasses.fields(ReplayReport)
              if f.name not in WALLS]
    for name in ("single", "fleet", "fleet_kill"):
        assert ({k: port["fleet"][name][k] for k in report}
                == {k: ref["fleet"][name][k] for k in report}), name
    assert port["fleet"]["bitwise_equal"] and port["fleet"]["zero_lost"]
    assert port["fleet"]["fleet_kill"]["worker_deaths"] == 1
    assert port["fleet"]["fleet_kill"]["requeued"] >= 1
    assert decisions(port["chaos"]) == decisions(ref["chaos"])


def test_subprocess_sigkill_dry_run(tmp_path):
    out = port_sched.main(["--dry-run", "--device", "cpu", "--workers", "2",
                           "--kill-one", "--transport", "subprocess",
                           "--sigkill", "--json", str(tmp_path / "p.json")])
    fleet = out["fleet"]
    assert fleet["bitwise_equal"] and fleet["zero_lost"]
    assert fleet["fleet_kill"]["worker_deaths"] >= 1
    assert out["chaos"]["fault"] == "sigkill"
    assert out["chaos"]["journal_recovery_equal"]
    saved = json.loads((tmp_path / "p.json").read_text())
    assert set(saved) == {"fleet", "chaos"}


def test_stream_dry_run(tmp_path):
    out = port_sched.main(["--dry-run", "--device", "cpu", "--stream",
                           "--json", str(tmp_path / "s.json")])
    sim = out["scheduler_sim"]
    for name in ("async_cold", "sequential", "async"):
        assert sim[name]["jobs"] == 8
    assert sim["sequential"]["solver_batches"] == 8
    assert sim["warmup"]["programs"] >= 1
    assert json.loads((tmp_path / "s.json").read_text()) == {
        "scheduler_sim": json.loads(json.dumps(sim))}


def test_engines_default_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_sched.main(["--dry-run", "--json", ""])
