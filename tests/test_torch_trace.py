"""The port's traces against ``repro.serve.trace``: ``synthetic_trace``
equal field for field for the same arguments, ``format_swf`` equal byte
for byte, ``parse_swf`` equal on SWF text with missing (``-1``) fields,
and ``default_flows`` equal bit for bit."""
import dataclasses

import numpy as np
import pytest

from repro.serve import rm as ref_rm
from repro.serve import trace as ref_trace
from repro_torch.serve import rm, trace

SWF_WITH_UNKNOWNS = "\n".join([
    "; Comment: archive header",
    ";",
    "1 0 -1 10 4 " + " ".join(["-1"] * 13),
    # allocated procs unknown (-1): falls back to requested procs (f8)
    "2 5 -1 10 -1 -1 -1 6 " + " ".join(["-1"] * 10),
    # runtime unknown: falls back to requested time (f9)
    "3 9 -1 -1 2 -1 -1 -1 77 " + " ".join(["-1"] * 9),
    # unusable: no size anywhere -> skipped
    "4 9 -1 10 -1 -1 -1 -1 " + " ".join(["-1"] * 10),
    # negative submit time -> skipped
    "5 -1 -1 10 4 " + " ".join(["-1"] * 13),
    # short line (8 fields), unknown runtime without a fallback
    "6 12.5 -1 -1 3.0 -1 -1 -1",
    "",
])


def _fields(jobs):
    out = []
    for j in jobs:
        d = dataclasses.asdict(j)
        d["C"] = None if j.C is None else np.asarray(j.C).tobytes()
        out.append(d)
    return out


def _same_jobs(want, got):
    assert [type(j).__name__ for j in got] == ["JobSpec"] * len(want)
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
@pytest.mark.parametrize("kw", [
    {},
    dict(sizes=(16, 32, 64, 128), weights=(4, 3, 2, 1), arrival_rate=0.5,
         mean_run_s=60.0),
    dict(sizes=(4, 6), weights=(1, 3), arrival_rate=2.0, mean_run_s=5.0),
    dict(sizes=(2, 3, 5, 8, 13), weights=(0, 1, 0.5, 2, 0), arrival_rate=7.0,
         mean_run_s=0.25),
], ids=["defaults", "torus512", "two-sizes", "zero-weights"])
def test_synthetic_trace_matches_reference(seed, kw):
    want = ref_trace.synthetic_trace(24, seed=seed, **kw)
    got = trace.synthetic_trace(24, seed=seed, **kw)
    _same_jobs(want, got)
    # a shorter trace draws the same first jobs
    _same_jobs(want[:8], trace.synthetic_trace(8, seed=seed, **kw))
    assert trace.format_swf(got) == ref_trace.format_swf(want)


@pytest.mark.parametrize("bad", [dict(num_jobs=0),
                                 dict(num_jobs=3, arrival_rate=0.0),
                                 dict(num_jobs=3, mean_run_s=-1.0),
                                 dict(num_jobs=3, sizes=(4, 6),
                                      weights=(1.0,)),
                                 dict(num_jobs=3, sizes=(4, 6),
                                      weights=(0.0, 0.0))])
def test_synthetic_trace_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError):
        ref_trace.synthetic_trace(**bad)
    with pytest.raises(ValueError):
        trace.synthetic_trace(**bad)


@pytest.mark.parametrize("header", [True, False])
def test_format_swf_matches_reference_bytes(header):
    specs = [dict(job_id=f"swf{i}", size=2 + (i % 4), run_s=10.4 + i,
                  arrival_s=5.5 * i, seed=i) for i in range(9)]
    specs.append(dict(job_id="no-digits", size=3, run_s=0.0))
    want = ref_trace.format_swf([ref_rm.JobSpec(**s) for s in specs],
                                header=header)
    got = trace.format_swf([rm.JobSpec(**s) for s in specs], header=header)
    assert got.encode() == want.encode()


@pytest.mark.parametrize("max_jobs", [None, 2])
def test_parse_swf_with_unknown_fields_matches_reference(max_jobs, tmp_path):
    want = ref_trace.parse_swf(SWF_WITH_UNKNOWNS, max_jobs=max_jobs)
    got = trace.parse_swf(SWF_WITH_UNKNOWNS, max_jobs=max_jobs)
    _same_jobs(want, got)
    assert [j.job_id for j in got][:2] == ["swf1", "swf2"]
    path = tmp_path / "t.swf"
    path.write_text(SWF_WITH_UNKNOWNS)
    _same_jobs(want, trace.parse_swf(str(path), max_jobs=max_jobs))
    _same_jobs(want, trace.parse_swf(SWF_WITH_UNKNOWNS.splitlines(),
                                     max_jobs=max_jobs))
    for mod in (ref_trace, trace):
        with pytest.raises(ValueError, match="malformed"):
            mod.parse_swf("1 2 3\n")


def test_swf_round_trip_is_a_fixed_point():
    jobs = trace.synthetic_trace(16, seed=3)
    text = trace.format_swf(jobs)
    back = trace.parse_swf(text)
    assert trace.format_swf(back) == text
    _same_jobs(ref_trace.parse_swf(text), back)


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 5), (16, 0), (45, 3),
                                    (128, 9)])
def test_default_flows_match_reference(n, seed):
    want = ref_rm.default_flows(n, seed)
    got = rm.default_flows(n, seed)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with pytest.raises(ValueError):
        rm.default_flows(0)
