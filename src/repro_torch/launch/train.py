"""End-to-end training launcher.

Wires together: config registry -> model on one device -> data pipeline
-> train step -> checkpoint manager with auto-resume.  The reference's
``repro/launch/train.py`` on the card (``device`` defaults to ``cuda``
and raises without one; pass ``device="cpu"`` / ``--device cpu`` for the
CPU):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_4b \\
        --smoke --steps 20 --device cpu

The port trains on one device.  A mesh of more than one device raises
``NotImplementedError``: sharding the parameters, optimizer state and
batch over a mesh is ROADMAP step 6, and the placement of a job's mesh
onto the machine (``placement != "none"``) is step 3.  On a one-device
mesh placement is skipped, as the reference skips it.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, Optional

import torch

from .. import configs, resolve_device
from ..models.api import Model
from ..models.config import ModelConfig
from ..models.transformer import FRONTEND_DIMS
from ..train import checkpoint as ckpt_lib
from ..train import data as data_lib
from ..train import optimizer as opt_lib
from ..train.step import make_train_step
from .mesh import Mesh


def _one_device(mesh: Optional[Mesh], device, placement: str) -> torch.device:
    """The device a one-device mesh names (``device`` when no mesh is
    given); raises for a larger mesh."""
    if mesh is None:
        return resolve_device(device)
    if mesh.size > 1:
        what = "sharding training over a mesh of several devices is " \
               "ROADMAP step 6"
        if placement != "none":
            what += f", and the job's placement ({placement!r}, " \
                    "launch.placement.place_job) is ROADMAP step 3"
        raise NotImplementedError(
            f"the port trains on one device; this mesh has {mesh.size} "
            f"({dict(mesh.shape)}): {what}")
    return resolve_device(mesh.devices.flat[0])


def train(cfg: ModelConfig, *, steps: int, global_batch: int, seq_len: int,
          lr: float = 3e-4, warmup: int = 50, microbatch: int = 1,
          checkpoint_dir: Optional[str] = None, checkpoint_every: int = 50,
          placement: str = "none", mesh=None, log_every: int = 10,
          seed: int = 0, device=None) -> Dict[str, Any]:
    """Train ``cfg`` for ``steps`` steps from random weights (seeded by
    ``seed``) or from the latest checkpoint in ``checkpoint_dir``.
    Returns ``history`` (a ``{"step", "loss", "grad_norm"}`` every
    ``log_every`` steps and at the last), ``placement`` (None: no
    placement on one device), ``final_loss`` and ``params``."""
    dev = _one_device(mesh, device, placement)
    model = Model(cfg, device=dev)
    ocfg = opt_lib.OptConfig(lr=lr, moment_dtype=cfg.opt_dtype)
    sched = opt_lib.warmup_cosine(lr, warmup, steps)
    dcfg = data_lib.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=global_batch,
        seed=seed, frontend=cfg.frontend,
        frontend_dim=FRONTEND_DIMS.get(cfg.frontend, 0))
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
            loss = float(metrics["loss"])
            history.append({"step": s + 1, "loss": loss,
                            "grad_norm": float(metrics["grad_norm"])})
            rate = (s + 1 - start_step) / (time.time() - t0)
            print(f"step {s+1:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{rate:.2f} steps/s", flush=True)
        if mgr and (s + 1) % checkpoint_every == 0:
            mgr.save(s + 1, {"params": params, "opt": opt_state})
    if mgr:
        mgr.save(steps, {"params": params, "opt": opt_state}, blocking=True)

    return {"history": history, "placement": None,
            "final_loss": history[-1]["loss"] if history else None,
            "params": params}


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
