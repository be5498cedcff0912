"""Workload traces for the resource manager: SWF parsing + synthesis.

The port of ``repro/serve/trace.py`` (numpy only): the same traces field
for field for the same seed, and the same SWF text byte for byte.

The Standard Workload Format (SWF, Feitelson's Parallel Workloads
Archive) is the lingua franca of scheduler evaluation: one job per
line, 18 whitespace-separated fields, ``;`` comment lines.  We read the
four fields the control plane needs -- job number (1), submit time (2),
run time (4), and number of allocated processors (5), falling back to
requested processors (8) and requested time (9) when the actuals are
missing (``-1``) -- and ignore the rest.  SWF carries no program
graphs, so parsed jobs get ``C=None`` and the manager synthesizes a
deterministic flow matrix per job (:func:`repro_torch.serve.rm.default_flows`).

:func:`synthetic_trace` generates a Poisson-arrival workload in the
same shape for benchmarks and tests; :func:`format_swf` writes any
sequence of :class:`~repro_torch.serve.rm.JobSpec` back out as SWF, so
handcrafted traces round-trip (``parse_swf(format_swf(jobs)) == jobs``
on the retained fields).
"""
from __future__ import annotations

import io
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from repro_torch.serve.rm import JobSpec

SWF_FIELDS = 18


def _to_lines(source: Union[str, Iterable[str]]) -> Iterable[str]:
    if isinstance(source, str):
        if "\n" in source or source.strip().startswith(";"):
            return io.StringIO(source)
        return open(source, "r", encoding="utf-8")
    return source


def parse_swf(source: Union[str, Iterable[str]], *,
              max_jobs: Optional[int] = None) -> List[JobSpec]:
    """Parse SWF text into :class:`JobSpec` objects.

    ``source`` is a path, the SWF text itself (anything containing a
    newline or starting with ``;``), or an iterable of lines.  Jobs with
    no usable size or a negative submit time are skipped, matching the
    archive's convention that ``-1`` means unknown.  Job ids become
    ``"swf<job number>"``; the job number also seeds the synthesized
    flow matrix so a trace replays identically every time.
    """
    jobs: List[JobSpec] = []
    lines = _to_lines(source)
    try:
        for raw in lines:
            line = raw.strip()
            if not line or line.startswith(";"):
                continue
            f = line.split()
            if len(f) < 5:
                raise ValueError(f"malformed SWF line (need >= 5 fields): "
                                 f"{line[:80]!r}")
            num = int(f[0])
            submit = float(f[1])
            run_s = float(f[3])
            size = int(float(f[4]))
            if size <= 0 and len(f) >= 8:          # fall back to requested
                size = int(float(f[7]))
            if run_s < 0 and len(f) >= 9:
                run_s = float(f[8])
            if size <= 0 or submit < 0:
                continue
            jobs.append(JobSpec(job_id=f"swf{num}", size=size,
                                run_s=max(run_s, 0.0), arrival_s=submit,
                                seed=num))
            if max_jobs is not None and len(jobs) >= max_jobs:
                break
    finally:
        if isinstance(lines, io.IOBase):
            lines.close()
    return jobs


def format_swf(jobs: Sequence[JobSpec], *, header: bool = True) -> str:
    """Render jobs as SWF text (18 columns, ``-1`` for unknown fields)."""
    out = []
    if header:
        # The reference's header, so both packages write the same bytes.
        out.append("; SWF trace written by repro.serve.trace")
        out.append(f"; MaxJobs: {len(jobs)}")
    for j in jobs:
        num = "".join(ch for ch in j.job_id if ch.isdigit()) or "0"
        row = [-1] * SWF_FIELDS
        row[0] = int(num)                  # 1: job number
        row[1] = int(round(j.arrival_s))   # 2: submit time
        row[2] = 0                         # 3: wait time (unknown yet)
        row[3] = int(round(j.run_s))       # 4: run time
        row[4] = j.size                    # 5: allocated processors
        row[7] = j.size                    # 8: requested processors
        row[8] = int(round(j.run_s))       # 9: requested time
        out.append(" ".join(str(v) for v in row))
    return "\n".join(out) + "\n"


def synthetic_trace(num_jobs: int = 32, *,
                    sizes: Sequence[int] = (6, 8, 12),
                    weights: Optional[Sequence[float]] = None,
                    arrival_rate: float = 2.0,
                    mean_run_s: float = 20.0,
                    seed: int = 0) -> List[JobSpec]:
    """Poisson arrivals, categorical sizes, exponential runtimes.

    Deterministic in ``seed``; flow matrices are left ``None`` so the
    manager synthesizes the standard ring+background recipe per job.
    ``arrival_rate`` is jobs per virtual second.
    """
    if num_jobs < 1:
        raise ValueError("num_jobs must be >= 1")
    if arrival_rate <= 0 or mean_run_s <= 0:
        raise ValueError("arrival_rate and mean_run_s must be > 0")
    rng = np.random.default_rng(seed)
    p = None
    if weights is not None:
        w = np.asarray(weights, np.float64)
        if w.shape != (len(sizes),) or (w < 0).any() or w.sum() == 0:
            raise ValueError("weights must be non-negative, one per size")
        p = w / w.sum()
    t = 0.0
    jobs = []
    for i in range(num_jobs):
        t += float(rng.exponential(1.0 / arrival_rate))
        size = int(rng.choice(np.asarray(sizes), p=p))
        run_s = float(rng.exponential(mean_run_s)) + 1e-3
        jobs.append(JobSpec(job_id=f"syn{i}", size=size, run_s=run_s,
                            arrival_s=t, seed=seed * 100003 + i))
    return jobs
