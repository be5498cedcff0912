"""The data-parallel world of ``tests/test_torch_placement_job.py`` (on
the CPU) and ``tests/test_torch_cuda.py`` (on the card): Qwen3's SMOKE
config in f32 on a (4, 1) mesh of gloo ranks, or one NCCL rank on the
card -- the first step's gradients and every step's loss and
collectives, unplaced and placed -- and the one-device step it is held
to.  The weights are drawn from a CPU generator on
either device, so the card's world meets the CPU's numbers.  Kept out of
the test modules (one imports JAX) so that the spawned ranks import
torch and the port only."""
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models.api import Model
from repro_torch.models.config import ShapeCell
from repro_torch.models.param import tree_flatten, tree_map, tree_unflatten
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import data_parallel as dp
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.step import make_train_step

WORLD = 4
MESH_SHAPE, AXES = (WORLD, 1), ("data", "model")
CELL = ShapeCell("train", 32, 8, "train")
STEPS, LR, WARMUP, SEED = 3, 3e-4, 1, 0


def config():
    """Qwen3's SMOKE config with f32 compute: the world's sums of
    per-rank f32 gradients differ from one device's only in order."""
    return dataclasses.replace(configs.smoke_config("qwen3_4b"),
                               compute_dtype=torch.float32)


def data_config(cfg):
    return data_lib.DataConfig(vocab_size=cfg.vocab_size,
                               seq_len=CELL.seq_len,
                               global_batch=CELL.global_batch, seed=SEED)


def batch(cfg, step, device="cpu"):
    return data_lib.to_device(data_lib.batch_at(data_config(cfg), step),
                              device)


def _weights(model):
    return model.init(torch.Generator().manual_seed(SEED))


PLACED = (3, 1, 0, 2)     # the ring's placement on the 2 x 2 torus


def _axis(device, ranks):
    """The data axis of a (len(ranks), 1) mesh whose position k is on
    rank ``ranks[k]``."""
    from torch.distributed.device_mesh import DeviceMesh
    grid = np.asarray(ranks).reshape(len(ranks), 1).tolist()
    return dp.data_axis(DeviceMesh(torch.device(device).type,
                                   torch.as_tensor(grid),
                                   mesh_dim_names=AXES))


def _first_step(model, axis, device):
    """The first step's global loss and gathered gradients (numpy, by
    tree) on ``axis``."""
    cfg = model.cfg
    dims = dp.shard_dims(model, axis)
    params = dp.shard_params(_weights(model), dims, axis)
    first = dp.shard_batch(cfg, CELL, batch(cfg, 0, device), axis)
    loss, grads = dp.make_loss_and_grads(model, axis)(params, first)
    return float(loss), tree_map(lambda g: g.cpu().numpy(),
                                 dp.gather_params(grads, dims, axis))


def dp_rank(world_mesh, device="cpu"):
    """On an unplaced (world, 1) mesh of ranks on ``device``: the first
    step's global loss and gathered gradients, then ``STEPS`` steps of
    the data-parallel train step -- each step's loss and collectives --
    and, on a CPU world of ``WORLD``, the first step on the ``PLACED``
    mesh with the reduce-scatters as all-reduce and slice (``placed``)
    and as the backend's own, in the NCCL path's shard order
    (``placed_native``)."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    axis = _axis(device, range(dist.get_world_size()))
    cfg = config()
    model = Model(cfg, device=device)
    loss, grads = _first_step(model, axis, device)
    dims = dp.shard_dims(model, axis)
    params = dp.shard_params(_weights(model), dims, axis)
    ocfg = opt_lib.OptConfig(lr=LR)
    step = dp.make_data_parallel_step(
        model, ocfg, opt_lib.warmup_cosine(LR, WARMUP, STEPS), axis)
    opt_state = opt_lib.init(ocfg, params)
    losses, traces = [], []
    for s in range(STEPS):
        local = dp.shard_batch(cfg, CELL, batch(cfg, s, device), axis)
        with coll.record_collectives() as ops:
            params, opt_state, metrics = step(params, opt_state, local)
        losses.append(float(metrics["loss"]))
        traces.append(list(ops))
    out = {"loss": loss, "grads": grads, "losses": losses, "traces": traces,
           "backend": dist.get_backend()}
    if device == "cpu" and dist.get_world_size() == WORLD:
        placed = _axis(device, PLACED)
        out["placed"] = _first_step(model, placed, device)
        native = coll.NATIVE_REDUCE_SCATTER
        coll.NATIVE_REDUCE_SCATTER = native | {dist.get_backend()}
        try:
            out["placed_native"] = _first_step(model, placed, device)
        finally:
            coll.NATIVE_REDUCE_SCATTER = native
    return out


def one_device(device="cpu"):
    """The one-device port step on the same global batches: the first
    step's loss and gradients by leaf (numpy), and every step's loss."""
    cfg = config()
    model = Model(cfg, device=device)
    params = _weights(model)
    leaves, treedef = tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss = model.loss(tree_unflatten(treedef, leaves), batch(cfg, 0, device))
    grads = [g.cpu().numpy() for g in torch.autograd.grad(loss, leaves)]
    ocfg = opt_lib.OptConfig(lr=LR)
    step = make_train_step(model, ocfg, opt_lib.warmup_cosine(
        LR, WARMUP, STEPS))
    opt_state, losses = opt_lib.init(ocfg, params), []
    for s in range(STEPS):
        params, opt_state, metrics = step(params, opt_state,
                                          batch(cfg, s, device))
        losses.append(float(metrics["loss"]))
    return float(loss.detach()), grads, losses
