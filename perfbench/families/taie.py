"""Taillard-style taiXXe instances of an order of the paper's Table 1
(``instances.taie``), a relabelling of their own for each version."""
from perfbench import instances


def make(config: dict, order: int, version: int) -> instances.Instance:
    return instances.taie(order, version)
