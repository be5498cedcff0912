"""The paper's parallel algorithms over devices, on ``torch.distributed``.

The port of ``repro/core/distributed.py``.  The paper's MPI processes are
the ranks of one dim of a ``torch.distributed.device_mesh.DeviceMesh``:
one rank = one SA solver group / GA island, SPMD as MPI is -- every rank
calls the same function with the same arguments and gets the same
answer.  This is one of the port's two kinds of mesh; the other, a
single-process grid of local devices that shards a wave's instances and
needs no collectives, is ``launch.mesh.Mesh`` (``core.batch_sharded``).

The exchanges are the reference's, as collectives on the dim's group:

* PSA best-broadcast and the final reduction -> an all_gather of each
  rank's (best f, best permutation), then the *first* argmin, so ties go
  to the lowest rank as ``jnp.argmin`` gives them;
* PGA ring migration -> ``batch_isend_irecv``: rank r sends its island's
  best to rank r+1 and receives rank r-1's (the reference's ``ppermute``
  over ``_ring_perm``); at one rank the ring is a copy;
* the generation's history entry -> ``all_reduce(MIN)`` (``pmin``).

The per-rank bodies are the single-process solvers' pieces
(``annealing.init_chain`` / ``_chain_round`` / ``_adopt_best``,
``genetic.init_island`` / ``breed`` / ``island_best`` /
``receive_migrants``), so every SA round runs the same hot loop (kernel
K1 or K4 on the card) and GA offspring are scored by K2.  As in the
reference, a rank's GA generation is ``genetic.breed``: host-regime
draws whatever ``GAConfig.eval`` and ``rng`` say.

The solver's tensors live on the mesh's device type (``cuda``: the
rank's current card; ``cpu``).  Gloo's all_gather and all_reduce take
CUDA tensors, but its send and recv take CPU tensors only (checked on an
H100 with torch 2.11), so on a gloo group the ring migration -- one
permutation and one float per rank and generation -- is staged through
host memory; NCCL exchanges device tensors.  Several ranks may share one
card only on gloo: NCCL refuses two ranks on one GPU.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Tuple

import torch
import torch.distributed as dist

from .. import as_tensor
from ..kernels import ops
from . import annealing, composite, genetic, keys, qap


def mesh_device(mesh) -> torch.device:
    """The device this rank's solver runs on: its current card for a
    ``cuda`` mesh, else the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class _Axis:
    """One mesh dim as the paper's process ring: its group, size, this
    rank's place on it and the device the solver runs on."""

    def __init__(self, mesh, axis: str):
        names = tuple(mesh.mesh_dim_names or ())
        if axis not in names:
            raise ValueError(f"mesh has no axis {axis!r}; axes: {names}")
        self.group = mesh.get_group(axis)
        self.size = mesh.size(names.index(axis))
        self.rank = mesh.get_local_rank(axis)
        self.device = mesh_device(mesh)
        # gloo sends and receives host memory only (see the module doc)
        self.p2p_on_host = dist.get_backend(self.group) == "gloo"

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``(size, ...)``: every rank's ``t``, in rank order."""
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return torch.stack(out)

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """Rank r's result is rank r-1's ``t`` (the reference's ppermute
        over ``_ring_perm``)."""
        if self.size == 1:
            # torch.distributed does not send to oneself; the ring of one
            # rank hands its own tensor on
            return t.clone()
        t = t.contiguous()
        w = t.cpu() if self.p2p_on_host else t
        out = torch.empty_like(w)
        peer = lambda r: dist.get_global_rank(self.group, r % self.size)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, w, peer(self.rank + 1), self.group),
            dist.P2POp(dist.irecv, out, peer(self.rank - 1), self.group)])
        for req in reqs:
            req.wait()
        return out.to(t.device)

    def pmin(self, t: torch.Tensor) -> torch.Tensor:
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return t


def _pack(f: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """One int32 row: the f32 bits of ``f`` and then ``p``."""
    return torch.cat([f.reshape(1).view(torch.int32), p.to(torch.int32)])


def _unpack(row: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return row[..., 0].contiguous().view(torch.float32), row[..., 1:]


def _global_argmin(ring: _Axis, f: torch.Tensor, p: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global best (f, p) across the ring: the first minimum over ranks."""
    fs, ps = _unpack(ring.all_gather(_pack(f, p)))
    i = qap.first_argmin(fs)
    return fs[i], ps[i]


def _inputs(C, M, key, ring: _Axis):
    dev = ring.device
    return (as_tensor(C, torch.float32, dev), as_tensor(M, torch.float32, dev),
            as_tensor(key, torch.int64, dev))


class _Chains:
    """One rank's SA solver group: ``solvers`` chains on one instance."""

    def __init__(self, C, M, kinit, kbeta, cfg: annealing.SAConfig):
        n = C.shape[-1]
        self.cfg = cfg
        self.inst = (C[None], M[None]) + ops.transposes(C[None], M[None])
        beta = annealing.make_beta(C, M, kbeta[None], cfg)
        self.beta = beta.expand(cfg.solvers)
        self.nv32 = annealing._nv32(None, n, cfg.solvers, C.device)
        self.state = annealing.init_chain(
            C, M, keys.split(kinit, cfg.solvers), cfg)

    def round(self, key: torch.Tensor) -> annealing.SAState:
        """``iters_per_exchange`` temperature steps of every chain."""
        self.state = annealing._chain_round(
            self.inst, self.state, keys.split(key, self.cfg.solvers),
            self.cfg, self.beta, None, self.nv32)
        return self.state

    def best(self) -> Tuple[torch.Tensor, torch.Tensor]:
        i = qap.first_argmin(self.state.best_f)
        return self.state.best_f[i], self.state.best_p[i]


def _evolve(C, M, state: genetic.GAState, gen_keys: torch.Tensor,
            cfg: genetic.GAConfig, ring: _Axis):
    """The island's generations with ring migration, then the global
    best: ``(perm, f, history)``."""
    C1, M1 = C[None], M[None]
    hist = []
    for k in gen_keys:
        state = genetic.breed(C1, M1, state, k[None], cfg)
        bp, bf = genetic.island_best(state)
        mig_f, mig_p = _unpack(ring.ring_shift(_pack(bf[0], bp[0])))
        state = genetic.receive_migrants(state, mig_p[None], mig_f.reshape(1))
        hist.append(ring.pmin(bf)[0])
    bp, bf = genetic.island_best(state)
    gf, gp = _global_argmin(ring, bf[0], bp[0])
    return gp, gf, torch.stack(hist) if hist else bf[:0]


def run_psa_mesh(C, M, key, cfg: annealing.SAConfig, mesh,
                 axis: str = "proc"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Parallel simulated annealing, one solver group per rank of the
    mesh dim ``axis``; after every round each rank adopts the global best.
    Returns ``(best_perm (N,), best_f, history (num_exchanges,))``, the
    same on every rank."""
    ring = _Axis(mesh, axis)
    C, M, key = _inputs(C, M, key, ring)
    kinit, kbeta, krun = keys.split(keys.split(key, ring.size)[ring.rank], 3)
    chains = _Chains(C, M, kinit, kbeta, cfg)
    n = C.shape[-1]
    hist = []
    for k in keys.split(krun, cfg.num_exchanges):
        chains.round(k)
        gf, gp = _global_argmin(ring, *chains.best())
        chains.state = annealing._adopt_best(
            chains.state, gp.expand(cfg.solvers, n).contiguous(),
            gf.expand(cfg.solvers).contiguous())
        hist.append(gf)
    gf, gp = _global_argmin(ring, *chains.best())
    return gp, gf, torch.stack(hist) if hist else gf.reshape(1)[:0]


def run_pga_mesh(C, M, key, cfg: genetic.GAConfig, mesh, axis: str = "proc"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Parallel GA, one island per rank of ``axis``, ring migration after
    every generation: ``(best_perm, best_f, history (generations,))``,
    the same on every rank."""
    ring = _Axis(mesh, axis)
    C, M, key = _inputs(C, M, key, ring)
    kinit, krun = keys.split(keys.split(key, ring.size)[ring.rank])
    state = genetic.init_island(C[None], M[None], kinit[None, None], cfg)
    return _evolve(C, M, state, keys.split(krun, cfg.generations), cfg, ring)


def run_pca_mesh(C, M, key, cfg: composite.CompositeConfig, mesh,
                 axis: str = "proc"
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite: each rank's SA chains without exchanges seed its
    island, then the GA with ring migration: ``(best_perm, best_f,
    ga_history)``, the same on every rank."""
    ring = _Axis(mesh, axis)
    C, M, key = _inputs(C, M, key, ring)
    solvers = composite._resolve_solvers(cfg, C.shape[-1])
    sa_cfg = replace(cfg.sa, solvers=solvers)
    kseed, kbeta, krun = keys.split(keys.split(key, ring.size)[ring.rank], 3)
    chains = _Chains(C, M, kseed, kbeta, sa_cfg)
    for k in keys.split(krun, sa_cfg.num_exchanges):
        chains.round(k)    # no exchange: populations stay unique (paper S3)
    state = genetic.GAState(pop=chains.state.best_p[None],
                            fit=chains.state.best_f[None])
    gen_keys = keys.split(keys.fold_in(krun, 1), cfg.ga.generations)
    return _evolve(C, M, state, gen_keys, cfg.ga, ring)
