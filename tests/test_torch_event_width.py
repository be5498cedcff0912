"""``SAConfig.event_width`` in the port against ``repro.core.annealing``:
every width (1, 2, 6, all ``max_neighbors`` candidates, ``"auto"``) gives
the reference's psa results at the same width bit for bit -- the event
loop (host draws), the fused loop (the plain K4) and the counter-regime
event and scan loops -- mirroring ``tests/test_hotloop.py`` and
``tests/test_fused.py``; the width's validation, the auto cache's
fallback and fill, and the engine's warmup under ``"auto"``."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.core import annealing as jann
from repro_torch import convert
from repro_torch.core import annealing
from repro_torch.kernels import ops
from repro_torch.kernels.qap_delta import qap_delta_plain
from repro_torch.kernels.qap_sa_step import event_loop
from repro_torch.serve.mapper import MappingEngine

from _fixtures import SA_SMALL, instance, padded_batch
from _torch_serve import one_torch_thread  # noqa: F401

WIDTHS = (1, 2, 6, SA_SMALL.max_neighbors, "auto")
LOOPS = (("event", "host"), ("fused", "counter"), ("event", "counter"),
         ("scan", "counter"))


def _port(cfg):
    return convert.sa_config_from_reference(dataclasses.asdict(cfg))


def _check_solve(want, got):
    for name, w, g in zip(("perm", "f", "history"), want, got):
        assert np.asarray(w).tobytes() == g.numpy().tobytes(), name


@pytest.mark.parametrize("width", WIDTHS, ids=str)
@pytest.mark.parametrize("loop,rng", LOOPS)
def test_psa_batch_at_every_width_matches_reference(loop, rng, width):
    """A padded, partly warm-started batch: the port's solve at ``width``
    equals the reference's at the same width, bit for bit (``"auto"``
    with an empty cache: each side's default)."""
    sizes = [8, 12, 16, 16]
    Cs, Ms, nvs, keys = padded_batch(sizes, bucket=16, seed0=5)
    cfg = dataclasses.replace(SA_SMALL, loop=loop, rng=rng, event_width=width)
    ips = np.full((4, 16), -1, np.int32)
    for i in (1, 3):
        ips[i, :sizes[i]] = np.random.default_rng(i).permutation(sizes[i])
        ips[i, sizes[i]:] = np.arange(sizes[i], 16)
    want = jann.run_psa_batch(Cs, Ms, keys, cfg, num_processes=2,
                              n_valid=nvs, init_perm=jnp.asarray(ips))
    got = annealing.run_psa_batch(np.asarray(Cs), np.asarray(Ms),
                                  np.asarray(keys), _port(cfg), 2,
                                  n_valid=np.asarray(nvs), init_perm=ips,
                                  device="cpu")
    _check_solve(want, got)


@pytest.mark.parametrize("width", (1, 3, None))
def test_widths_give_the_scan_results(width):
    """tests/test_hotloop.py's golden check on the port: every width of
    the event loop equals the sequential scan, on one unpadded
    instance."""
    C, M = instance(12, 9)
    key = np.asarray(jax.random.PRNGKey(6))
    golden = annealing.run_psa(C, M, key, _port(dataclasses.replace(
        SA_SMALL, loop="scan")), 2, device="cpu")
    got = annealing.run_psa(C, M, key, _port(dataclasses.replace(
        SA_SMALL, event_width=width)), 2, device="cpu")
    for a, b in zip(golden, got):
        assert a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("width", (1, 2, 6, 10))
def test_event_loop_windows_one_delta_call_a_round(width):
    """``event_loop`` at ``width``: the states of the full width, and one
    delta call of ``(B, width)`` candidates a round, at most
    ``min(max_success, K) + ceil(K / width)`` rounds."""
    rng = np.random.default_rng(3)
    B, n, K, cap = 6, 12, 10, 4
    C, M = (torch.as_tensor(x) for x in instance(n, 4))
    p = torch.as_tensor(np.stack([rng.permutation(n) for _ in range(B)]),
                        dtype=torch.int32)
    f = qap_delta_plain(C, M, p, torch.zeros(B, 1, 2, dtype=torch.int32))[:, 0]
    f = f + 100.0
    temp = torch.full((B,), 30.0)
    a = torch.as_tensor(rng.integers(0, n, (B, K)))
    b = (a + 1 + torch.as_tensor(rng.integers(0, n - 1, (B, K)))) % n
    pairs = torch.stack([a, b], -1).to(torch.int32)
    us = torch.as_tensor(rng.random((B, K)), dtype=torch.float32)
    widths = []

    def delta(pp, pr):
        widths.append(pr.shape[1])
        return qap_delta_plain(C, M, pp, pr)

    want = event_loop(lambda pp, pr: qap_delta_plain(C, M, pp, pr),
                      p, f, p, f, temp, pairs, us, cap)
    got = event_loop(delta, p, f, p, f, temp, pairs, us, cap, width)
    for w_, g in zip(want, got):
        assert w_.numpy().tobytes() == g.numpy().tobytes()
    assert set(widths) == {width}
    assert len(widths) <= min(cap, K) + -(-K // width)


def test_plain_k4_takes_event_width():
    """``ops.qap_sa_step`` on CPU tensors windows its plain version by
    ``event_width`` and gives the same states at every width."""
    n, B = 16, 4
    C, M = (torch.as_tensor(x) for x in instance(n, 2))
    p = torch.as_tensor(np.stack([np.random.default_rng(i).permutation(n)
                                  for i in range(B)]), dtype=torch.int32)
    f = torch.full((B,), 1e4)
    args = (C, M, p, f, p, f, torch.full((B,), 50.0),
            torch.as_tensor([[0, i] for i in range(B)]),
            torch.full((B,), n, dtype=torch.int32))
    outs = [ops.qap_sa_step(*args, max_neighbors=10, max_success=3,
                            event_width=w) for w in (None, 1, 4)]
    for out in outs[1:]:
        for a, b in zip(outs[0], out):
            assert a.numpy().tobytes() == b.numpy().tobytes()


def test_event_width_validation():
    """The reference's cases (tests/test_hotloop.py, tests/test_fused.py)
    on the port."""
    cfg = _port(SA_SMALL)
    assert annealing.resolved_event_width(cfg, device="cpu") == \
        jann.resolved_event_width(SA_SMALL) == 6
    assert annealing.resolved_event_width(
        dataclasses.replace(cfg, event_width=999), device="cpu") == \
        cfg.max_neighbors
    for bad in (0, -3, "bogus", 2.5):
        with pytest.raises(ValueError, match="event_width"):
            annealing.resolved_event_width(
                dataclasses.replace(cfg, event_width=bad), device="cpu")
        with pytest.raises(ValueError, match="event_width"):
            jann.resolved_event_width(
                dataclasses.replace(SA_SMALL, event_width=bad))


def test_defaults_by_device():
    """Every candidate on the card, ``min(6, max_neighbors)`` on the CPU;
    ``device`` defaults to the card, which raises without one."""
    assert annealing._default_event_width(50, "cpu") == 6
    assert annealing._default_event_width(4, "cpu") == 4
    assert annealing._default_event_width(50, "cpu") == \
        jann._default_event_width(50)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            annealing.resolved_event_width(_port(SA_SMALL))


@pytest.fixture
def empty_width_cache():
    saved = dict(annealing._EVENT_WIDTH_CACHE)
    annealing._EVENT_WIDTH_CACHE.clear()
    try:
        yield annealing._EVENT_WIDTH_CACHE
    finally:
        annealing._EVENT_WIDTH_CACHE.clear()
        annealing._EVENT_WIDTH_CACHE.update(saved)


def test_auto_falls_back_then_reads_the_filled_cache(empty_width_cache):
    """``"auto"`` with an empty cache is the device's default; the
    autotune fills the per-(device type, n) cache it then reads, and a
    second call measures nothing."""
    cfg = dataclasses.replace(_port(SA_SMALL), event_width="auto")
    assert annealing.resolved_event_width(cfg, 16, "cpu") == \
        annealing._default_event_width(cfg.max_neighbors, "cpu")
    w = annealing.autotune_event_width(16, max_neighbors=cfg.max_neighbors,
                                       repeats=1, device="cpu")
    assert w in annealing._AUTO_WIDTHS
    assert empty_width_cache == {("cpu", 16): w}
    assert annealing.resolved_event_width(cfg, 16, "cpu") == \
        min(w, cfg.max_neighbors)
    empty_width_cache[("cpu", 16)] = 2
    assert annealing.autotune_event_width(16, device="cpu") == 2
    assert annealing.resolved_event_width(cfg, 16, "cpu") == 2
    assert annealing.resolved_event_width(cfg, 32, "cpu") == 6


def test_auto_solves_equal_the_default(empty_width_cache):
    """A filled cache changes no result (tests/test_fused.py's check)."""
    C, M = instance(16, 88)
    key = np.asarray(jax.random.PRNGKey(6))
    cfg = _port(SA_SMALL)
    base = annealing.run_psa(C, M, key, cfg, 2, device="cpu")
    empty_width_cache[("cpu", 16)] = 1
    auto = annealing.run_psa(C, M, key, dataclasses.replace(
        cfg, event_width="auto"), 2, device="cpu")
    for a, b in zip(base, auto):
        assert a.numpy().tobytes() == b.numpy().tobytes()


def test_engine_warmup_autotunes_each_bucket(empty_width_cache):
    """``MappingEngine.warmup`` fills the cache at every bucket it warms
    when a tier's SA config asks for ``"auto"``, and not otherwise."""
    sa = annealing.SAConfig(max_neighbors=6, iters_per_exchange=2,
                            num_exchanges=1, solvers=2)
    plain = MappingEngine(buckets=(16, 32), sa_cfg=sa, num_processes=1,
                          device="cpu")
    plain.warmup(algorithms=("psa",))
    assert empty_width_cache == {}
    auto = MappingEngine(buckets=(16, 32), num_processes=1, device="cpu",
                         sa_cfg=dataclasses.replace(sa, event_width="auto"))
    auto.warmup(algorithms=("psa",))
    assert set(empty_width_cache) == {("cpu", 16), ("cpu", 32)}
    assert set(empty_width_cache.values()) <= set(annealing._AUTO_WIDTHS)
