"""The general traffic generator: a mix file (``traffic/<mix>.json``) and
a configuration's instance family (``families/<family>.py``) make every
request of a run from ``--seed``.

A mix file holds:

* ``loop``: the loop kind that sends the requests, ``loops/<loop>.py``;
* ``pass_size``: requests in a pass;
* ``orders``: ``{order: share}``; every pass holds the same number of
  requests of each order (shares rounded to whole requests), in an order
  of its own;

and whatever else its loop kind reads.

The stream has no end, and pass ``k`` depends on ``--seed`` and ``k``
alone, whenever it is made: a loop makes each pass while the card solves
an earlier one, so a faster program never runs out of requests.  Each
request is a distinct instance, with a version no other request of the
run has and a solver seed of its own, so no digest repeats and the
engine's exact-answer cache serves none.
"""
from __future__ import annotations

from typing import List, NamedTuple, Set, Tuple

import numpy as np

from . import byname


class Request(NamedTuple):
    job_id: str
    C: np.ndarray
    M: np.ndarray
    optimum: float
    seed: int


def pass_orders(orders: dict, size: int) -> np.ndarray:
    """The orders of a pass of ``size`` requests in the mix's shares,
    sorted."""
    keys = sorted(int(k) for k in orders)
    shares = np.array([float(orders[str(k)]) for k in keys])
    counts = np.floor(shares / shares.sum() * size).astype(np.int64)
    counts[np.argmax(shares)] += size - counts.sum()
    return np.repeat(keys, counts)


class Stream:
    """The run's requests, a pass at a time."""

    def __init__(self, config: dict, mix: dict, seed: int) -> None:
        self.config = config
        self.family = byname.load("families", config["family"])
        self.size = int(mix["pass_size"])
        self.orders = pass_orders(mix["orders"], self.size)
        self.rng = np.random.default_rng(seed % 2 ** 64)
        self.versions: Set[int] = set()
        self.made = 0

    def specs(self) -> List[Tuple[int, int, int]]:
        """``(order, version, solver seed)`` of the next pass."""
        orders = self.rng.permutation(self.orders)
        versions: List[int] = []
        while len(versions) < self.size:
            for v in self.rng.integers(1, 2 ** 31, size=self.size):
                if len(versions) < self.size and int(v) not in self.versions:
                    self.versions.add(int(v))
                    versions.append(int(v))
        seeds = self.rng.integers(0, 2 ** 31, size=self.size)
        return [(int(n), v, int(s)) for n, v, s in zip(orders, versions,
                                                        seeds)]

    def next_pass(self) -> List[Request]:
        out = []
        for order, version, seed in self.specs():
            inst = self.family.make(self.config, order, version)
            out.append(Request(f"r{self.made}", inst.C, inst.M,
                               inst.optimum, seed))
            self.made += 1
        return out
