"""End-to-end training launcher.

Wires together: config registry -> mesh (+ optional QAP placement, the
paper's technique) -> data pipeline -> train step -> checkpoint manager
with auto-resume.  The reference's ``repro/launch/train.py`` on the card
(``device`` defaults to ``cuda`` and raises without one; pass
``device="cpu"`` / ``--device cpu`` for the CPU, and a mesh of CPU
devices for a world on the CPU):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b \\
        --smoke --steps 20 --device cpu

Without a mesh, or on a mesh of one device, the model trains on one
device (``train.step.make_train_step``).  A larger mesh of ("pod",)
"data" and "model" axes trains sharded (``parallel.data_parallel``:
ZeRO-3 over the data axes, tensor-parallel over ``model``) in a world of
one rank per mesh position (``launch.world.run_world``): rank r runs on
the mesh's r-th device, NCCL when those are distinct cards, else gloo
(several ranks on one card, or the CPU).  With ``placement`` ("psa",
"pga" or "pca") the step is first lowered (``launch.lowering``), its
collectives placed on the mesh's torus (``launch.placement.place_job``)
and the world's mesh built in the placed rank order: logical coordinate
k on rank ``perm[k]``.  A model the tensor-parallel step does not cover
raises before any world starts (``sharding.check_mesh``).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import configs, resolve_device
from ..models.api import Model
from ..models.config import ModelConfig, ShapeCell
from ..models.param import tree_map
from ..models.transformer import FRONTEND_DIMS
from ..parallel import sharding as sh
from ..train import checkpoint as ckpt_lib
from ..train import data as data_lib
from ..train import optimizer as opt_lib
from ..train.step import make_train_step
from .mesh import Mesh, canonical_device

WORLD_TIMEOUT_S = 3600.0


def train(cfg: ModelConfig, *, steps: int, global_batch: int, seq_len: int,
          lr: float = 3e-4, warmup: int = 50, microbatch: int = 1,
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 50,
          placement: str = "none", mesh=None, log_every: int = 10,
          seed: int = 0, device=None) -> Dict[str, Any]:
    """Train ``cfg`` for ``steps`` steps from random weights (seeded by
    ``seed``) or from the latest checkpoint in ``checkpoint_dir``.
    Returns ``history`` (a ``{"step", "loss", "grad_norm"}`` every
    ``log_every`` steps and at the last), ``placement`` (None, or
    ``{"algorithm", "gain", "cost_before", "cost_after", "perm"}``),
    ``final_loss`` and ``params`` (on the device, or on the CPU after a
    world).  A world's run adds ``ranks``: each rank's first-step
    collectives (``trace``), peak device bytes (``peak_bytes``) and wall
    seconds before its loop (``setup_seconds``), in it, the final gather
    included (``seconds``), and of each step (``step_seconds``)."""
    if mesh is None or mesh.size == 1:
        dev = resolve_device(device if mesh is None
                             else mesh.devices.flat[0])
        return _train_one_device(
            cfg, dev, steps=steps, global_batch=global_batch,
            seq_len=seq_len, lr=lr, warmup=warmup, microbatch=microbatch,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            log_every=log_every, seed=seed)
    sh.check_mesh(mesh, cfg)
    return _train_world(
        cfg, mesh, steps=steps, global_batch=global_batch, seq_len=seq_len,
        lr=lr, warmup=warmup, microbatch=microbatch,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        placement=placement, log_every=log_every, seed=seed)


def _log(history, s, start_step, t0, metrics) -> None:
    loss = float(metrics["loss"])
    history.append({"step": s + 1, "loss": loss,
                    "grad_norm": float(metrics["grad_norm"])})
    rate = (s + 1 - start_step) / (time.time() - t0)
    print(f"step {s+1:5d}  loss {loss:.4f}  "
          f"gnorm {float(metrics['grad_norm']):.3f}  "
          f"{rate:.2f} steps/s", flush=True)


def _data_config(cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int) -> data_lib.DataConfig:
    return data_lib.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch,
        seed=seed, frontend=cfg.frontend,
        frontend_dim=FRONTEND_DIMS.get(cfg.frontend, 0))


def _train_one_device(cfg, dev, *, steps, global_batch, seq_len, lr, warmup,
                      microbatch, checkpoint_dir, checkpoint_every, log_every,
                      seed) -> Dict[str, Any]:
    model = Model(cfg, device=dev)
    ocfg = opt_lib.OptConfig(lr=lr, moment_dtype=cfg.opt_dtype)
    sched = opt_lib.warmup_cosine(lr, warmup, steps)
    dcfg = _data_config(cfg, global_batch, seq_len, seed)
    # one device: one data-parallel group (the reference's num_groups is
    # the mesh's data x pod width)
    step_fn = make_train_step(model, ocfg, sched, microbatch=microbatch)

    # ---- init or resume --------------------------------------------------
    mgr = None
    start_step = 0
    params = opt_state = None
    if checkpoint_dir:
        mgr = ckpt_lib.CheckpointManager(
            checkpoint_dir, cfg_hash=ckpt_lib.config_hash((cfg, ocfg)))
        latest = mgr.latest_step()
        if latest is not None:
            print(f"[resume] restoring step {latest}")
            like = {"params": model.abstract(),
                    "opt": opt_lib.abstract_state(ocfg, model.abstract())}
            restored = mgr.restore(latest, like, device=dev)
            params, opt_state = restored["params"], restored["opt"]
            start_step = latest
    if params is None:
        params = model.init(seed=seed)
        opt_state = opt_lib.init(ocfg, params)

    # ---- loop --------------------------------------------------------------
    history = []
    t0 = time.time()
    for s in range(start_step, steps):
        batch = data_lib.to_device(data_lib.batch_at(dcfg, s), dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (s + 1) % log_every == 0 or s + 1 == steps:
            _log(history, s, start_step, t0, metrics)
        if mgr and (s + 1) % checkpoint_every == 0:
            mgr.save(s + 1, {"params": params, "opt": opt_state})
    if mgr:
        mgr.save(steps, {"params": params, "opt": opt_state}, blocking=True)

    return {"history": history, "placement": None,
            "final_loss": history[-1]["loss"] if history else None,
            "params": params}


def _train_world(cfg, mesh: Mesh, *, steps, global_batch, seq_len, lr, warmup,
                 microbatch, checkpoint_dir, checkpoint_every, placement,
                 log_every, seed) -> Dict[str, Any]:
    from .world import run_world
    devices = [canonical_device(d) for d in mesh.devices.reshape(-1)]
    kinds = {d.type for d in devices}
    if len(kinds) != 1:
        raise ValueError(f"a mesh of {sorted(kinds)} devices")
    device_type = kinds.pop()
    resolve_device(device_type)
    n = len(devices)
    distinct = len({d.index for d in devices}) == n
    backend = "nccl" if device_type == "cuda" and distinct else "gloo"
    cell = ShapeCell("train", seq_len, global_batch, "train")

    # ---- paper technique: topology-aware placement ------------------------
    perm = np.arange(n)
    placement_info = None
    if placement != "none":
        from .lowering import lower_train_cell
        from .placement import PlacementService, default_service, place_job
        lowered = lower_train_cell(cfg, cell, mesh)
        service = default_service() if device_type == "cuda" \
            else PlacementService(device=device_type)
        _, pres = place_job(lowered, mesh, algorithm=placement,
                            service=service)
        perm = np.asarray(pres.perm)
        placement_info = {"algorithm": placement, "gain": pres.gain,
                          "cost_before": pres.cost_before,
                          "cost_after": pres.cost_after,
                          "perm": perm.tolist()}
        print(f"[placement] {placement}: predicted comm-cost gain "
              f"{pres.gain:.1%}")

    # rank 0 hands the whole parameters back through a file: a pickle
    # through the world's result queue would copy them several times
    handoff = tempfile.mkdtemp(prefix="repro_train_")
    try:
        t = time.time()
        ranks = run_world(
            _train_rank, n, device_type=device_type, backend=backend,
            timeout_s=WORLD_TIMEOUT_S, args=(
                cfg, perm.reshape(mesh.devices.shape).tolist(),
                tuple(mesh.axis_names), [str(d) for d in devices], cell,
                dict(steps=steps, lr=lr, warmup=warmup, microbatch=microbatch,
                     checkpoint_dir=checkpoint_dir,
                     checkpoint_every=checkpoint_every, log_every=log_every,
                     seed=seed, handoff=os.path.join(handoff, "params.pt"))))
        world_s = time.time() - t
        params = torch.load(os.path.join(handoff, "params.pt"),
                            weights_only=True)
    finally:
        shutil.rmtree(handoff, ignore_errors=True)
    print(f"[train] world of {n} {backend} ranks on {device_type}: "
          f"{world_s:.1f} s (rank 0: setup {ranks[0]['setup_seconds']:.1f} "
          f"s, loop {ranks[0]['seconds']:.1f} s); parameters read back in "
          f"{time.time() - t - world_s:.1f} s", flush=True)
    history = ranks[0].pop("history")
    return {"history": history, "placement": placement_info,
            "final_loss": history[-1]["loss"] if history else None,
            "params": params, "ranks": ranks}


def _train_rank(world_mesh, cfg: ModelConfig, rank_grid: List, axis_names,
                devices: List[str], cell: ShapeCell, kw: Dict[str, Any]
                ) -> Dict[str, Any]:
    """One rank of :func:`train`'s world: the sharded loop on this rank's
    position of the placed mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from ..parallel import collectives as coll
    from ..parallel import data_parallel as dp

    t_rank = time.time()
    rank = dist.get_rank()
    dev = canonical_device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    else:       # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // dist.get_world_size()))
    mesh = DeviceMesh(dev.type, torch.as_tensor(rank_grid),
                      mesh_dim_names=tuple(axis_names))
    axis, model_axis = dp.data_axis(mesh), dp.model_axis(mesh)
    steps = kw["steps"]
    model = Model(cfg, device=dev)
    ocfg = opt_lib.OptConfig(lr=kw["lr"], moment_dtype=cfg.opt_dtype)
    sched = opt_lib.warmup_cosine(kw["lr"], kw["warmup"], steps)
    dcfg = _data_config(cfg, cell.global_batch, cell.seq_len, kw["seed"])
    layout = dp.param_layout(model, axis, model_axis)
    state_layout = dp.state_layout(model, ocfg, axis, model_axis)
    step_fn = dp.make_data_parallel_step(model, ocfg, sched, axis,
                                         microbatch=kw["microbatch"],
                                         model_axis=model_axis)

    def shard_state(params, opt_state):
        return layout.shard(params), state_layout.shard(opt_state)

    def whole_state(params, opt_state):
        return {"params": layout.gather(params),
                "opt": state_layout.gather(opt_state)}

    # ---- init or resume (whole trees, then this rank's shards) -----------
    mgr = None
    start_step = 0
    params = opt_state = None
    if kw["checkpoint_dir"]:
        mgr = ckpt_lib.CheckpointManager(
            kw["checkpoint_dir"], cfg_hash=ckpt_lib.config_hash((cfg, ocfg)))
        latest = mgr.latest_step()
        if latest is not None:
            if rank == 0:
                print(f"[resume] restoring step {latest}")
            like = {"params": model.abstract(),
                    "opt": opt_lib.abstract_state(ocfg, model.abstract())}
            restored = mgr.restore(latest, like, device=dev)
            params, opt_state = shard_state(restored["params"],
                                            restored["opt"])
            del restored
            start_step = latest
    if params is None:
        whole = model.init(seed=kw["seed"])
        params = layout.shard(whole)
        del whole
        opt_state = opt_lib.init(ocfg, params)     # zeros: the shards'

    def save(step, blocking=False):
        state = whole_state(params, opt_state)
        if rank == 0:
            mgr.save(step, state, blocking=blocking)
        del state

    # ---- loop --------------------------------------------------------------
    history, trace = [], None
    t0 = time.time()
    setup_s = t0 - t_rank
    step_seconds = []
    for s in range(start_step, steps):
        t_step = time.time()
        batch = dp.shard_batch(
            cfg, cell, data_lib.to_device(data_lib.batch_at(dcfg, s), dev),
            axis)
        with coll.record_collectives() as ops:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        float(metrics["loss"])          # waits for the step's end
        step_seconds.append(time.time() - t_step)
        if trace is None:
            trace = list(ops)
        if (s + 1) % kw["log_every"] == 0 or s + 1 == steps:
            if rank == 0:
                _log(history, s, start_step, t0, metrics)
        if mgr and (s + 1) % kw["checkpoint_every"] == 0:
            save(s + 1)
    if mgr:
        save(steps, blocking=True)
    whole = layout.gather(params)
    out = {"trace": trace, "setup_seconds": setup_s,
           "seconds": time.time() - t0, "step_seconds": step_seconds,
           "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                          if dev.type == "cuda" else None)}
    if rank == 0:
        torch.save(tree_map(lambda t: t.cpu(), whole), kw["handoff"])
        out["history"] = history
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--placement", default="none",
                    choices=["none", "psa", "pga", "pca"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args()

    cfg = configs.smoke_config(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    out = train(cfg, steps=args.steps, global_batch=args.global_batch,
                seq_len=args.seq_len, lr=args.lr, microbatch=args.microbatch,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every,
                placement=args.placement, device=args.device)
    print(json.dumps({k: v for k, v in out.items() if k != "params"},
                     indent=1, default=str))


if __name__ == "__main__":
    main()
