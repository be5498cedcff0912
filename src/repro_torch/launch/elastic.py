"""Elastic scaling and failure handling.

The paper's core constraint -- "it is not known in advance which specific
nodes will be allocated for the job" -- is the elastic-restart case: when
nodes fail or the pool resizes, the launcher

  1. picks the largest feasible mesh from the surviving devices
     (:func:`remesh`),
  2. re-runs the placement on the new system graph,
  3. restores the latest checkpoint onto the new mesh
     (``train.checkpoint.CheckpointManager.restore``),
  4. resumes from the recorded step -- the deterministic data pipeline
     (``train/data.py``) makes every host's shard a pure function of the
     step.

Stragglers: synchronous steps bound them to one step; the
:class:`Watchdog` detects persistent ones (heartbeat timeouts) so the
launcher can take the same resize path without them.  The reference's
``repro/launch/elastic.py`` on the port's ``launch.mesh.Mesh``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .mesh import Mesh, make_mesh_with_devices


def largest_feasible_shape(n_devices: int, model_axis: int
                           ) -> Tuple[int, ...]:
    """Largest (data, model) grid with the model axis preserved.

    The tensor-parallel degree is fixed by the model's sharding (weights
    are laid out for it); elasticity trades data-parallel width.
    """
    if n_devices < model_axis:
        raise ValueError(f"{n_devices} devices cannot sustain model axis "
                         f"{model_axis}")
    data = n_devices // model_axis
    # a power-of-two data axis keeps batch divisibility stable
    data = 1 << (data.bit_length() - 1)
    return (data, model_axis)


def remesh(devices: Sequence, model_axis: int,
           axes: Tuple[str, ...] = ("data", "model")) -> Mesh:
    shape = largest_feasible_shape(len(devices), model_axis)
    used = int(np.prod(shape))
    return make_mesh_with_devices(list(devices)[:used], shape, axes)


@dataclass
class Watchdog:
    """Heartbeat tracker: hosts report per-step completion times; hosts that
    exceed ``timeout_s`` since their last beat are declared failed."""
    timeout_s: float = 300.0
    beats: Dict[int, float] = field(default_factory=dict)

    def beat(self, host: int, now: Optional[float] = None) -> None:
        self.beats[host] = time.monotonic() if now is None else now

    def failed_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [h for h, t in self.beats.items() if now - t > self.timeout_s]

    def straggler_hosts(self, factor: float = 3.0,
                        now: Optional[float] = None) -> List[int]:
        """Hosts whose staleness exceeds ``factor`` x the median staleness."""
        now = time.monotonic() if now is None else now
        if len(self.beats) < 3:
            return []
        stale = {h: now - t for h, t in self.beats.items()}
        med = float(np.median(list(stale.values())))
        return [h for h, s in stale.items()
                if s > factor * max(med, 1e-3) and s > 1.0]
