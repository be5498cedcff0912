"""The system graph G_s of a job's placement: hop distances on a torus of
chips.

A pod is a ``side_x`` x ``side_y`` 2D torus of chips; pods connect over
a slower inter-pod network, modelled as an additive hop penalty.  The
*distance matrix* M (edge weights m_ij of G_s) is what the QAP
functional (1) consumes: m_ij = torus hop count within a pod, plus
``dci_penalty`` across pods.

The hop model of the reference's ``repro/topology/tpu.py``, and only it:
the reference's link, memory and compute rates of a TPU chip
(``ICI_BW``, ``HBM_BW``, ``PEAK_FLOPS``, ``HBM_PER_CHIP``) describe
another machine and are not carried into the port.  ``DCI_PENALTY`` is
a distance in hops, not a rate.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

DCI_PENALTY = 16.0       # extra distance units for crossing pods


@dataclass(frozen=True)
class PodSpec:
    side_x: int = 16
    side_y: int = 16
    num_pods: int = 1
    dci_penalty: float = DCI_PENALTY

    @property
    def chips_per_pod(self) -> int:
        return self.side_x * self.side_y

    @property
    def num_chips(self) -> int:
        return self.chips_per_pod * self.num_pods


def torus_coords(spec: PodSpec, chip: int) -> Tuple[int, int, int]:
    pod, rem = divmod(chip, spec.chips_per_pod)
    y, x = divmod(rem, spec.side_x)
    return pod, x, y


def _torus_dist(a: int, b: int, side: int) -> int:
    d = abs(a - b)
    return min(d, side - d)


def distance_matrix(spec: PodSpec) -> np.ndarray:
    """(num_chips, num_chips) hop distances -- the system graph M."""
    n = spec.num_chips
    coords = np.array([torus_coords(spec, i) for i in range(n)])
    pod = coords[:, 0]
    x, y = coords[:, 1], coords[:, 2]
    dx = np.abs(x[:, None] - x[None, :])
    dx = np.minimum(dx, spec.side_x - dx)
    dy = np.abs(y[:, None] - y[None, :])
    dy = np.minimum(dy, spec.side_y - dy)
    m = (dx + dy).astype(np.float32)
    cross = (pod[:, None] != pod[None, :])
    m = m + cross.astype(np.float32) * spec.dci_penalty
    np.fill_diagonal(m, 0.0)
    return m


def spec_for_mesh_shape(shape: Tuple[int, ...]) -> PodSpec:
    """The torus of a mesh's chips: up to 256 a single pod folded into a
    near-square block (``ceil(sqrt(n))`` wide, so 8 chips give a 3 x 3
    pod of 9), above that whole 16 x 16 pods."""
    total = int(np.prod(shape))
    if total <= 256:
        # single pod (or a slice of one): fold into a <=16x16 block
        side = int(np.ceil(np.sqrt(total)))
        return PodSpec(side_x=side, side_y=int(np.ceil(total / side)), num_pods=1)
    assert total % 256 == 0, f"unsupported chip count {total}"
    return PodSpec(num_pods=total // 256)
