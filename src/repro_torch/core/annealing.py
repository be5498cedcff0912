"""Parallel simulated annealing (PSA) for the mapping problem.

The algorithm of ``repro/core/annealing.py`` (paper S3), with every
``vmap`` axis written out as one leading batch: all ``instances x
processes x solvers`` chains of a wave advance together, rows of one
instance contiguous (the kernels' ``r // (B // B0)`` contract).

A temperature level examines up to ``max_neighbors`` candidate swaps and
accepts at most ``max_success`` of them.  ``SAConfig.loop`` picks how:

* ``"event"`` (default): acceptance-event rounds, a window of
  ``resolved_event_width`` candidates of every chain (all of them on the
  card) scored in one ``kernels.ops.qap_delta`` call (kernel K1 on the
  card), the first accepted one applied;
* ``"fused"``: one ``kernels.ops.qap_sa_step`` launch (kernel K4) runs
  the whole level, candidates drawn on the card from the counter stream;
* ``"scan"``: the sequential candidate scan, the golden reference.

All three give the same states.  ``init_chain``, ``_chain_round`` and
``_adopt_best`` are the per-process pieces that ``core.distributed``
runs on each rank.  ``SAConfig.rng`` picks the draws:
``"host"`` replays the reference's ``jax.random`` calls (``core.keys``),
``"counter"`` (implied by ``"fused"``) the Threefry counter stream.
``SAConfig.flows="sparse"`` takes ``C`` as a ``core.sparse.SparseFlows``:
every objective and delta then runs the O(nnz) path (kernels K6/K7 on
the card), and ``"fused"`` runs as ``"event"``.

Three formulas are computed in the form XLA compiles them to on the
reference side, so that temperatures -- which feed every Metropolis
test -- agree bit for bit:

* T0 = ``mu * f0 / -log(phi)`` is ``f0 * K`` with the constant
  ``K = mu * (1 / -log(phi))`` folded in f32;
* beta = ``(T0 - Tf) / (n_cool * T0 * Tf)`` is
  ``fma(f0, K, -Tf) / (f0 * ((n_cool * Tf) * K))``, the constants folded
  in f32 and the numerator contracted into one rounding;
* the Cauchy step ``T / (1 + beta * T)`` rounds ``1 + beta * T`` once
  (a fused multiply-add).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .. import as_tensor, resolve_device
from ..kernels import ops, prng
from ..kernels.qap_delta import qap_delta_plain
from ..kernels.qap_sa_step import event_loop
from ..kernels.qap_sparse import qap_delta_sparse_plain
from . import keys, qap
from .sparse import SparseFlows


@dataclass(frozen=True)
class SAConfig:
    max_neighbors: int = 50          # candidates per temperature (Figs 1-2)
    max_success: int = 10            # acceptance cap per temperature
    schedule: str = "cauchy"         # "linear" | "cauchy" (Fig 3)
    q: float = 0.95                  # linear-schedule decay factor
    mu: float = 0.3                  # T0 = mu * F(s0) / -ln(phi)
    phi: float = 0.3
    t_final: float = 1e-3
    iters_per_exchange: int = 100    # temperature steps between exchanges (Fig 4)
    num_exchanges: int = 50          # total iterations = c * iters_per_exchange
    solvers: int = 125               # chains per process (Fig 5)
    seed_with: Optional[str] = None  # None | "identity": chain 0 starts
                                     # from the as-allocated order
    loop: str = "event"              # "event" | "scan" | "fused" (same results)
    rng: str = "host"                # "host" (jax.random replay) | "counter"
    event_width: Union[int, str, None] = None
                                     # candidates scored per event round:
                                     # None (the device's default), an int
                                     # or "auto" (measured; see
                                     # resolved_event_width); results never
                                     # depend on it
    flows: str = "dense"             # "dense" | "sparse": C as a
                                     # core.sparse.SparseFlows (convert once,
                                     # host-side, via sparse.prepare_flows)


class SAState(NamedTuple):
    p: torch.Tensor        # current permutation per chain   (B, N) int32
    f: torch.Tensor        # current objective               (B,)
    best_p: torch.Tensor   # best-so-far permutation         (B, N) int32
    best_f: torch.Tensor   # best-so-far objective           (B,)
    temp: torch.Tensor     # current temperature             (B,)


def _f32(x) -> float:
    return float(np.float32(x))


def _t0_factor(mu: float, phi: float) -> float:
    """``mu / -log(phi)`` folded as XLA folds it: ``mu * (1 / c)`` in f32."""
    c = np.float32(-np.log(np.float32(phi)))
    return _f32(np.float32(mu) * np.float32(np.float32(1.0) / c))


def initial_temperature(f0: torch.Tensor, mu: float, phi: float
                        ) -> torch.Tensor:
    return f0 * _t0_factor(mu, phi)


def cool(temp: torch.Tensor, cfg: SAConfig, beta: torch.Tensor
         ) -> torch.Tensor:
    if cfg.schedule == "linear":
        return temp * _f32(cfg.q)
    if cfg.schedule == "cauchy":
        # 1 + beta*T rounded once: the f64 product of two f32 is exact.
        return temp / (beta.double() * temp.double() + 1.0).float()
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def make_beta(C: torch.Tensor, M: torch.Tensor, key: torch.Tensor,
              cfg: SAConfig, n_valid=None) -> torch.Tensor:
    """Cauchy beta from T0/Tf and the total number of coolings, one per
    key: ``C``/``M`` shared or ``(B0, N, N)`` with ``key (B0, 2)``."""
    n = C.shape[-1]
    if n_valid is None:
        p0 = qap.random_permutation(key, n)
    else:
        p0 = qap.masked_random_permutation(key, n, n_valid)
    f0 = qap.objective(C, M, p0)
    k = _t0_factor(cfg.mu, cfg.phi)
    tf = _f32(cfg.t_final)
    n_cool = cfg.num_exchanges * cfg.iters_per_exchange
    den = _f32(np.float32(np.float32(n_cool) * np.float32(tf)) * np.float32(k))
    num = (f0.double() * k - tf).float()
    return num / (f0 * den)


def resolved_loop(cfg: SAConfig, n: Optional[int] = None) -> str:
    """The hot-loop realisation that runs at order ``n``: ``"fused"``
    degrades to the equivalent ``"event"`` above the fused step's cap and
    for sparse flows, which the fused kernel does not read."""
    if cfg.loop not in ("event", "scan", "fused"):
        raise ValueError(f"unknown hot-loop realisation {cfg.loop!r}")
    if cfg.loop == "fused" and (cfg.flows == "sparse" or (
            n is not None and not ops.fused_step_fits(n))):
        return "event"
    return cfg.loop


_CPU_EVENT_WIDTH = 6   # balances wasted re-evaluation in the acceptance-
                       # dense (hot) phase against extra rounds in the
                       # sparse (cold) phase on the CPU (the reference's)

# event_width="auto": measured widths, cached per (device type, n).  Filled
# eagerly by autotune_event_width (the engine's warmup, benchmarks); a
# miss falls back to the device's default, so results never depend on
# whether the autotune ran.
_EVENT_WIDTH_CACHE: dict = {}
_AUTO_WIDTHS = (1, 2, 4, 6, 8, 12, 16, 24, 32)
_AUTO_SUCCESSES = 5    # cost-model round counts: a temperature level runs
_AUTO_CANDIDATES = 50  # ~(successes + candidates / width) wide rounds


def _default_event_width(max_neighbors: int, device=None) -> int:
    """The device's width without a measurement: every candidate on the
    card (one K1 launch covers all of them), a narrow window on the
    CPU, where scoring them all every round costs more than it saves."""
    if resolve_device(device).type == "cuda":
        return max_neighbors
    return min(_CPU_EVENT_WIDTH, max_neighbors)


def autotune_event_width(n: int, max_neighbors: int = 50,
                         repeats: int = 3, device=None) -> int:
    """One-shot measured pick for ``SAConfig.event_width="auto"`` on
    ``device`` (the card by default).

    Times ``ops.qap_delta`` (K1 on the card) at each candidate width on
    a synthetic order-``n`` instance, synchronising, and picks the width
    minimising the event loop's cost model ``(successes + candidates /
    width) * t(width)`` -- a temperature level pays one round per
    acceptance plus enough rounds to sweep the candidate list.  The
    result is cached per (device type, n); the width never changes
    results, so tuning is a pure throughput knob.
    """
    dev = resolve_device(device)
    cached = _EVENT_WIDTH_CACHE.get((dev.type, n))
    if cached is not None:
        return cached
    gen = torch.Generator().manual_seed(0)
    C = torch.round(torch.rand((n, n), generator=gen) * 9.0).to(dev)
    M = torch.round(torch.rand((n, n), generator=gen) * 9.0).to(dev)
    p = torch.arange(n, dtype=torch.int32, device=dev)[None]
    key = keys.prng_key(0, dev)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    best_w, best_cost = None, float("inf")
    for w in _AUTO_WIDTHS:
        pairs = qap.random_swap_pairs(key, w, n)[None]
        ops.qap_delta(C, M, p, pairs)                     # first use
        sync()
        t0 = time.perf_counter()
        for _ in range(repeats):
            ops.qap_delta(C, M, p, pairs)
        sync()
        t = (time.perf_counter() - t0) / repeats
        cost = (_AUTO_SUCCESSES + _AUTO_CANDIDATES / w) * t
        if cost < best_cost:
            best_w, best_cost = w, cost
    _EVENT_WIDTH_CACHE[(dev.type, n)] = best_w
    return best_w


def resolved_event_width(cfg: SAConfig, n: Optional[int] = None,
                         device=None) -> int:
    """Candidates scored per acceptance-event round on ``device`` (the
    card by default).

    ``cfg.event_width`` when set to an int; ``"auto"`` reads the
    per-(device type, n) measured cache (:func:`autotune_event_width`)
    and falls back to the device's default on a miss; otherwise the
    default (:func:`_default_event_width`).  The width changes only how
    much is scored per round, never which candidates are accepted, so
    results are the same bits for every width.
    """
    if cfg.event_width == "auto":
        w = _EVENT_WIDTH_CACHE.get((resolve_device(device).type, n))
        if w is None:
            w = _default_event_width(cfg.max_neighbors, device)
        return max(1, min(w, cfg.max_neighbors))
    if cfg.event_width is not None:
        if not isinstance(cfg.event_width, int) or cfg.event_width < 1:
            raise ValueError(
                f"event_width must be >= 1 or 'auto', got {cfg.event_width!r}")
        return min(cfg.event_width, cfg.max_neighbors)
    return _default_event_width(cfg.max_neighbors, device)


def _check(cfg: SAConfig) -> None:
    if cfg.rng not in ("host", "counter"):
        raise ValueError(f"unknown rng regime {cfg.rng!r}")
    if cfg.flows not in ("dense", "sparse"):
        raise ValueError(f"flows must be 'dense' or 'sparse', got {cfg.flows!r}")


def _draws(key: torch.Tensor, cfg: SAConfig, n: int, n_valid):
    """Candidate pairs ``(..., K, 2)`` and uniforms ``(..., K)`` for
    ``(..., 2)`` step keys; ``n_valid`` broadcasts against ``(...)``."""
    k = cfg.max_neighbors
    if cfg.rng == "counter" or cfg.loop == "fused":
        return prng.sa_step_draws(key, k, n if n_valid is None else n_valid)
    sub = keys.split(key)
    pairs = qap.random_swap_pairs(sub[..., 0, :], k, n, n_valid)
    return pairs, keys.uniform(sub[..., 1, :], (k,))


def _candidate_scan(C, M, state: SAState, pairs, us, cfg: SAConfig):
    """Golden reference hot loop (``loop="scan"``): the sequential
    candidate scan with the acceptance cap, over every chain at once."""
    p, f, best_p, best_f = state.p, state.f, state.best_p, state.best_f
    tsafe = state.temp.clamp_min(1e-9)
    successes = torch.zeros_like(f, dtype=torch.long)
    plain = qap_delta_sparse_plain if isinstance(C, SparseFlows) \
        else qap_delta_plain
    for t in range(cfg.max_neighbors):
        ab = pairs[:, t]
        d = plain(C, M, p, ab[:, None, :])[:, 0]
        accept = (((d < 0) | (us[:, t] < torch.exp(-d / tsafe)))
                  & (successes < cfg.max_success))
        p = torch.where(accept[:, None], qap.swap_positions(p, ab[:, 0], ab[:, 1]), p)
        f = torch.where(accept, f + d, f)
        better = f < best_f
        best_p = torch.where(better[:, None], p, best_p)
        best_f = torch.where(better, f, best_f)
        successes = successes + accept.long()
    return p, f, best_p, best_f


def _advance(inst, state: SAState, key, pairs, us, cfg: SAConfig,
             beta, nv32) -> SAState:
    """One temperature level for every chain, draws already made (none
    for the fused loop, which draws on the card).  ``inst`` is
    ``(C, M, C^T, M^T)``."""
    C, M, CT, MT = inst
    n = state.p.shape[-1]
    loop = resolved_loop(cfg, n)
    if loop == "fused":
        p, f, best_p, best_f = ops.qap_sa_step(
            C, M, state.p, state.f, state.best_p, state.best_f, state.temp,
            key, nv32, max_neighbors=cfg.max_neighbors,
            max_success=cfg.max_success,
            event_width=resolved_event_width(cfg, n, state.p.device),
            CT=CT, MT=MT)
    elif loop == "event":
        p, f, best_p, best_f = event_loop(
            lambda pp, pr: ops.qap_delta(C, M, pp, pr, CT, MT),
            state.p, state.f, state.best_p, state.best_f, state.temp,
            pairs, us, cfg.max_success,
            resolved_event_width(cfg, n, state.p.device))
    else:
        p, f, best_p, best_f = _candidate_scan(C, M, state, pairs, us, cfg)
    temp = cool(state.temp, cfg, beta).clamp_min(_f32(cfg.t_final))
    return SAState(p=p, f=f, best_p=best_p, best_f=best_f, temp=temp)


def _nv32(n_valid, n: int, b: int, device) -> torch.Tensor:
    if n_valid is None:
        return torch.full((b,), n, dtype=torch.int32, device=device)
    return torch.as_tensor(n_valid, device=device).to(torch.int32).expand(b) \
        .contiguous()


def temperature_step(C: torch.Tensor, M: torch.Tensor, state: SAState,
                     key: torch.Tensor, cfg: SAConfig, beta,
                     n_valid=None) -> SAState:
    """One temperature level for ``B`` chains: state tensors ``(B, ...)``,
    step keys ``(B, 2)``, ``beta`` scalar or ``(B,)``, ``n_valid`` None or
    ``(B,)``; ``C``/``M`` shared or ``(B0, N, N)``."""
    _check(cfg)
    b, n = state.p.shape
    beta = torch.as_tensor(beta, dtype=torch.float32, device=state.f.device)
    pairs = us = None
    if resolved_loop(cfg, n) != "fused":
        pairs, us = _draws(key, cfg, n, n_valid)
    return _advance((C, M) + ops.transposes(C, M), state, key, pairs, us, cfg,
                    beta.expand(b), _nv32(n_valid, n, b, state.p.device))


def _chain_round(inst, state: SAState, key: torch.Tensor,
                 cfg: SAConfig, beta, n_valid, nv32) -> SAState:
    """``iters_per_exchange`` temperature steps for every chain; the
    host-side draws of the whole round are made in one call."""
    n = state.p.shape[-1]
    step_keys = keys.split(key, cfg.iters_per_exchange)          # (B, I, 2)
    pairs = us = None
    if resolved_loop(cfg, n) != "fused":
        pairs, us = _draws(step_keys, cfg, n,
                           None if n_valid is None else n_valid[:, None])
        # step-major, so that each step's slice is contiguous
        pairs, us = pairs.transpose(0, 1).contiguous(), us.transpose(0, 1)
    step_keys = step_keys.transpose(0, 1).contiguous()
    for t in range(cfg.iters_per_exchange):
        state = _advance(inst, state, step_keys[t],
                         None if pairs is None else pairs[t],
                         None if us is None else us[t], cfg, beta, nv32)
    return state


def init_chain(C, M: torch.Tensor, key: torch.Tensor, cfg: SAConfig,
               identity: Optional[torch.Tensor] = None,
               n_valid=None) -> SAState:
    """Start states for a leading batch of chains, ``key (..., 2)`` ->
    state fields ``(..., ...)``: a random permutation per key (identity
    on a padded tail past ``n_valid``, which broadcasts against the
    batch), or ``identity`` (``(..., N)``, the as-allocated order) for
    every chain, scored against shared ``(N, N)`` ``C``/``M``, at the
    initial temperature."""
    n = C.shape[-1]
    if identity is not None:
        p = identity.to(torch.int32).expand(key.shape[:-1] + (n,)).contiguous()
    elif n_valid is None:
        p = qap.random_permutation(key, n)
    else:
        p = qap.masked_random_permutation(key, n, n_valid)
    f = qap.objective(C, M, p)
    return SAState(p=p, f=f, best_p=p, best_f=f,
                   temp=initial_temperature(f, cfg.mu, cfg.phi))


def _adopt_best(state: SAState, best_p: torch.Tensor,
                best_f: torch.Tensor) -> SAState:
    """Paper: each process makes the broadcast best its candidate
    solution (``best_p``/``best_f`` shaped as the state's fields)."""
    better = best_f < state.best_f
    return state._replace(p=best_p, f=best_f,
                          best_p=torch.where(better[..., None], best_p,
                                             state.best_p),
                          best_f=torch.minimum(best_f, state.best_f))


def seed_chain0(C, M: torch.Tensor, init: SAState, chain_key: torch.Tensor,
                cfg, num_processes: int, init_perm: torch.Tensor,
                init_chain_fn) -> SAState:
    """Seed chain 0 of every process of one instance from a warm-start
    permutation ``init_perm (N,)``: ``init`` holds ``(num_processes,
    solvers, ...)`` fields, ``chain_key (2,)``.  A negative first entry
    is the "no warm start" sentinel and keeps the chain-0 states already
    in ``init``, so a cold instance inside a warm batch solves as in a
    cold-only batch."""
    n = C.shape[-1]
    use = init_perm[0] >= 0
    perm = torch.where(use, init_perm.to(torch.int32),
                       torch.arange(n, dtype=torch.int32,
                                    device=init_perm.device))
    seeded = init_chain_fn(C, M, chain_key, cfg, identity=perm)
    out = []
    for all_, one in zip(init, seeded):
        all_ = all_.clone()
        all_[:, 0] = torch.where(use, one.expand_as(all_[:, 0]), all_[:, 0])
        out.append(all_)
    return SAState(*out)


def _seed_chain0(C, M, state: SAState, perm, use, cfg: SAConfig,
                 num_processes: int) -> SAState:
    """Chain 0 of every process starts from ``perm`` (``(B0, N)``) where
    ``use`` (``(B0,)``) holds; state fields are ``(B0, R, ...)``."""
    f = qap.objective(C, M, perm)
    seeded = (perm, f, perm, f, initial_temperature(f, cfg.mu, cfg.phi))
    rows = torch.arange(num_processes, device=perm.device) * cfg.solvers
    out = []
    for field, one in zip(state, seeded):
        field = field.clone()
        old = field[:, rows]                                  # (B0, P, ...)
        u = use.view((-1, 1) + (1,) * (one.dim() - 1))
        field[:, rows] = torch.where(u, one[:, None].expand_as(old), old)
        out.append(field)
    return SAState(*out)


def anneal_chains(C: torch.Tensor, M: torch.Tensor, key: torch.Tensor,
                  cfg: SAConfig, num_processes: int, exchange: bool,
                  n_valid: Optional[torch.Tensor] = None,
                  init_perm: Optional[torch.Tensor] = None,
                  seed_identity: bool = False
                  ) -> Tuple[SAState, torch.Tensor]:
    """Every chain of a wave of ``B0`` instances through ``num_exchanges``
    rounds of ``iters_per_exchange`` temperature steps: PSA's body, and
    with ``exchange=False`` the composite algorithm's first stage.

    ``C`` (already masked past ``n_valid``) and ``M`` are ``(B0, N, N)``,
    ``key (B0, 2)``.  Chain 0 of every process starts from the identity
    with ``seed_identity``, then from ``init_perm`` where its first entry
    is not negative.  With ``exchange`` every chain adopts its instance's
    best after each round.  Returns the chains' state, ``(B0 * R, ...)``
    with ``R = num_processes * cfg.solvers`` chains per instance, and each
    instance's best after each round, ``(B0, num_exchanges)``.
    """
    _check(cfg)
    b0, n = C.shape[0], C.shape[-1]
    r = num_processes * cfg.solvers
    dev = C.device
    ks = keys.split(key, 3)
    kinit, kbeta, krun = ks[:, 0], ks[:, 1], ks[:, 2]
    beta = make_beta(C, M, kbeta, cfg, n_valid)

    chain_keys = keys.split(kinit, r)                             # (B0, R, 2)
    if n_valid is None:
        p = qap.random_permutation(chain_keys, n)
    else:
        p = qap.masked_random_permutation(chain_keys, n, n_valid[:, None])
    f = qap.objective(C, M, p)
    state = SAState(p, f, p, f, initial_temperature(f, cfg.mu, cfg.phi))
    ident = torch.arange(n, dtype=torch.int32, device=dev).expand(b0, n)
    if seed_identity:
        state = _seed_chain0(C, M, state, ident,
                             torch.ones(b0, dtype=torch.bool, device=dev),
                             cfg, num_processes)
    if init_perm is not None:
        # a negative first entry keeps the chain-0 state the config made
        use = init_perm[:, 0] >= 0
        perm = torch.where(use[:, None], init_perm.to(torch.int32), ident)
        state = _seed_chain0(C, M, state, perm, use, cfg, num_processes)

    inst = (C, M) + ops.transposes(C, M)
    beta_c = beta.repeat_interleave(r)
    nv_c = None if n_valid is None else n_valid.repeat_interleave(r)
    nv32 = _nv32(nv_c, n, b0 * r, dev)
    flat = SAState(*(x.reshape((b0 * r,) + x.shape[2:]) for x in state))
    round_keys = keys.split(krun, cfg.num_exchanges)              # (B0, E, 2)
    history = []
    rows = torch.arange(b0, device=dev)
    for e in range(cfg.num_exchanges):
        ck = keys.split(round_keys[:, e], r).reshape(b0 * r, 2)
        flat = _chain_round(inst, flat, ck, cfg, beta_c, nv_c, nv32)
        best_f = flat.best_f.view(b0, r)
        best_p = flat.best_p.view(b0, r, n)
        i = qap.first_argmin(best_f)
        gbest_f, gbest_p = best_f[rows, i], best_p[rows, i]
        history.append(gbest_f)
        if exchange:
            better = gbest_f[:, None] < best_f
            flat = SAState(
                p=gbest_p.repeat_interleave(r, dim=0),
                f=gbest_f.repeat_interleave(r),
                best_p=torch.where(better[..., None], gbest_p[:, None],
                                   best_p).reshape(b0 * r, n),
                best_f=torch.minimum(gbest_f[:, None], best_f).reshape(-1),
                temp=flat.temp)
    return flat, torch.stack(history, dim=1)


def _psa_impl(C: torch.Tensor, M: torch.Tensor, key: torch.Tensor,
              cfg: SAConfig, num_processes: int, exchange: bool,
              n_valid: Optional[torch.Tensor],
              init_perm: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PSA over a wave of ``B0`` instances, ``C``/``M`` ``(B0, N, N)``
    (``C`` may be a ``SparseFlows`` with ``(B0, N, D)`` leaves)."""
    if cfg.flows == "sparse" and not isinstance(C, SparseFlows):
        raise TypeError(
            "SAConfig.flows='sparse' requires C as a core.sparse.SparseFlows"
            " -- convert host-side with sparse.prepare_flows(C, 'sparse')")
    if n_valid is not None:
        C = qap.mask_flows(C, n_valid)
    flat, history = anneal_chains(C, M, key, cfg, num_processes, exchange,
                                  n_valid, init_perm,
                                  cfg.seed_with == "identity")
    b0, n = C.shape[0], C.shape[-1]
    best_f = flat.best_f.view(b0, -1)
    i = qap.first_argmin(best_f)
    rows = torch.arange(b0, device=C.device)
    return flat.best_p.view(b0, -1, n)[rows, i], best_f[rows, i], history


def lead(C):
    """``C`` with a leading instance dim of 1, dense or sparse."""
    return C.unsqueeze0() if isinstance(C, SparseFlows) else C[None]


def wave_inputs(Cs, Ms, key, n_valid=None, init_perm=None, device=None):
    """A solver wave's inputs as tensors on the entry point's device
    (``cuda`` unless ``device`` says otherwise): ``(C, M, key, n_valid,
    init_perm)``; a ``SparseFlows`` ``Cs`` moves leaf by leaf."""
    dev = resolve_device(device)
    C = Cs.to(dev) if isinstance(Cs, SparseFlows) else as_tensor(
        Cs, torch.float32, dev)
    return (C, as_tensor(Ms, torch.float32, dev),
            as_tensor(key, torch.int64, dev),
            None if n_valid is None else as_tensor(n_valid, torch.int64, dev),
            None if init_perm is None else as_tensor(init_perm, torch.int32, dev))


def run_psa_batch(Cs, Ms, key, cfg: SAConfig, num_processes: int = 4,
                  exchange: bool = True, n_valid=None, init_perm=None,
                  device=None):
    """Instance-batched PSA: ``Cs``/``Ms`` ``(B, N, N)`` padded instances
    (``Cs`` a ``SparseFlows`` with ``(B, N, D)`` leaves for sparse flows),
    ``key (B, 2)`` one key per instance, ``n_valid`` optional ``(B,)``,
    ``init_perm`` optional ``(B, N)`` warm starts (a negative first entry
    leaves that instance cold).  Returns ``(best_perms (B, N), best_fs
    (B,), history (B, num_exchanges))``; entry b equals ``run_psa`` on
    instance b.  Runs on ``cuda`` unless ``device`` says otherwise."""
    C, M, k, nv, ip = wave_inputs(Cs, Ms, key, n_valid, init_perm, device)
    return _psa_impl(C, M, k, cfg, num_processes, exchange, nv, ip)


def run_psa(C, M, key, cfg: SAConfig, num_processes: int = 4,
            exchange: bool = True, n_valid=None, init_perm=None,
            device=None):
    """Parallel SA on one instance: ``(best_perm, best_f, history)``."""
    C, M, k, nv, ip = wave_inputs(C, M, key, n_valid, init_perm, device)
    p, f, hist = _psa_impl(lead(C), M[None], k[None], cfg, num_processes,
                           exchange, None if nv is None else nv.reshape(1),
                           None if ip is None else ip[None])
    return p[0], f[0], hist[0]
