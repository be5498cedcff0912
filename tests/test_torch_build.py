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


def test_launch_counts_are_exact_across_threads():
    """Engines of a thread-backed fleet launch from several threads: 8
    threads counting 10 000 launches each (half on a branch) lose none,
    with the interpreter switching threads as often as it can."""
    import sys
    import threading
    ops.reset_launch_counts()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        start = threading.Barrier(8)

        def work(i):
            start.wait()
            for j in range(10_000):
                build.count_launch("qap_delta", ("smem", "l2")[j % 2]
                                   if i % 2 else None)
        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        [t.start() for t in threads]
        [t.join(timeout=120) for t in threads]
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert ops.launch_counts()["qap_delta"] == 80_000
    assert ops.branch_counts()["qap_delta/smem"] == 20_000
    assert ops.branch_counts()["qap_delta/l2"] == 20_000
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


def test_count_launch_and_reset_take_the_count_lock():
    """An increment waits while another thread holds ``COUNT_LOCK`` (as
    ``reset_launch_counts`` and the readers do), so no count is lost to
    an interleaved read and write."""
    import threading
    ops.reset_launch_counts()
    with build.COUNT_LOCK:
        t = threading.Thread(target=build.count_launch,
                             args=("qap_delta", "smem"))
        t.start()
        t.join(timeout=0.2)
        assert t.is_alive()                 # blocked on the lock
        assert build.LAUNCHES["qap_delta"] == 0
    t.join(timeout=10)
    assert not t.is_alive()
    assert ops.launch_counts()["qap_delta"] == 1
    assert ops.branch_counts()["qap_delta/smem"] == 1
    ops.reset_launch_counts()
