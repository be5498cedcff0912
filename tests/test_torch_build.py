"""The ctypes bindings of the CUDA kernels against their C sources.

``kernels/build.py`` binds every exported C function once, when its
library loads, from the signature table ``build.SIGNATURES``.  A table
that disagrees with a source would hand the card a cut pointer or a
shifted argument, so the table is read against the ``extern "C"``
declarations of ``csrc/*.cu`` here, where there is no compiler.
"""
import re

import pytest
import torch

from repro_torch.kernels import build, ops

_DECL = re.compile(r'extern "C"\s+([\w ]+?)\s+(\w+)\(([^)]*)\)', re.S)
_LETTER = {"int": "i", "long long": "q", "float": "f"}


def _letter(param: str) -> str:
    if "*" in param:
        return "p"
    return _LETTER[" ".join(param.split()[:-1])]


def _exports(name):
    """``{function: "ret:args"}`` of ``csrc/<name>.cu``."""
    src = (build.CSRC / f"{name}.cu").read_text()
    out = {}
    for ret, fn, params in _DECL.findall(src):
        args = [p.strip() for p in params.split(",") if p.strip()]
        out[fn] = _LETTER[ret.strip()] + ":" + "".join(map(_letter, args))
    return out


@pytest.mark.parametrize("name", build.KERNELS)
def test_signature_table_matches_the_c_source(name):
    assert build.SIGNATURES[name] == _exports(name)


def test_every_kernel_has_a_signature_and_a_source():
    assert set(build.SIGNATURES) == set(build.KERNELS)
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").is_file()


def test_branch_counts_start_at_zero_and_reset():
    ops.reset_launch_counts()
    assert ops.branch_counts() == {
        "qap_delta/smem": 0, "qap_delta/l2": 0,
        "qap_sa_step/smem": 0, "qap_sa_step/l2": 0,
        "qap_objective/smem": 0, "qap_objective/l2": 0,
        "qap_ga_step/smem": 0, "qap_ga_step/l2": 0}
    for key in ops.branch_counts():
        build.BRANCH_LAUNCHES[key] += 2
        build.LAUNCHES[key.split("/")[0]] += 2
    assert set(ops.branch_counts().values()) == {2}
    ops.reset_launch_counts()
    assert set(ops.branch_counts().values()) == {0}
    assert set(ops.launch_counts().values()) == {0}


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    rng = torch.Generator().manual_seed(0)
    C = torch.randint(0, 9, (2, 16, 16), generator=rng).float()
    M = torch.randint(1, 9, (2, 16, 16), generator=rng).float()
    p = torch.stack([torch.randperm(16, generator=rng) for _ in range(4)])
    pairs = torch.tensor([[[0, 1], [2, 5], [3, 15]]] * 4, dtype=torch.int32)
    ops.reset_launch_counts()
    got = ops.qap_delta(C, M, p.int(), pairs)
    assert got.shape == (4, 3)
    assert all(v == 0 for v in ops.launch_counts().values())
    assert all(v == 0 for v in ops.branch_counts().values())
