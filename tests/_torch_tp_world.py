"""The tensor-parallel worlds of ``tests/test_torch_tensor_parallel.py``
(on the CPU) and ``tests/test_torch_cuda.py`` (on the card): an
architecture's SMOKE config in f32 on a (data, model) mesh of gloo ranks
-- the first step's loss, whole gradients and collectives, unplaced and
on a placed order of the same ranks, then every step's loss and
collectives -- and the one-device step it is held to.  The weights come
from a CPU generator on either device, so the card's world meets the
CPU's numbers.  Kept out of the test modules (one imports JAX) so that
the spawned ranks import torch and the port only."""
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models.api import Model
from repro_torch.models.config import ShapeCell
from repro_torch.models.param import tree_flatten, tree_map, tree_unflatten
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import data_parallel as dp
from repro_torch.train import data as data_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.step import make_train_step

AXES = ("data", "model")
CELL = ShapeCell("train", 32, 8, "train")
STEPS, LR, WARMUP, SEED = 3, 3e-4, 1, 0


def config(arch):
    """``arch``'s SMOKE config with f32 compute: the world's sums differ
    from one device's only in order."""
    return dataclasses.replace(configs.smoke_config(arch),
                               compute_dtype=torch.float32)


def batch(cfg, step, device="cpu"):
    return data_lib.to_device(data_lib.batch_at(data_lib.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=CELL.seq_len,
        global_batch=CELL.global_batch, seed=SEED), step), device)


def weights(model):
    return model.init(torch.Generator().manual_seed(SEED))


def _axes(device, shape, ranks):
    """The data and model axes of a ``shape`` mesh over AXES whose
    position k is on rank ``ranks[k]``."""
    from torch.distributed.device_mesh import DeviceMesh
    grid = np.asarray(ranks).reshape(shape).tolist()
    mesh = DeviceMesh(torch.device(device).type, torch.as_tensor(grid),
                      mesh_dim_names=AXES)
    return dp.data_axis(mesh), dp.model_axis(mesh)


def _first_step(model, axis, model_axis, device):
    """The first step's global loss, whole gradients (numpy, by leaf) and
    collectives."""
    cfg = model.cfg
    layout = dp.param_layout(model, axis, model_axis)
    params = layout.shard(weights(model))
    first = dp.shard_batch(cfg, CELL, batch(cfg, 0, device), axis)
    step = dp.make_loss_and_grads(model, axis, model_axis=model_axis)
    with coll.record_collectives() as ops_:
        loss, grads = step(params, first)
    whole = tree_flatten(layout.gather(grads))[0]
    return float(loss), [g.cpu().numpy() for g in whole], list(ops_)


def tp_rank(world_mesh, arch, shape, placed=None, device="cpu"):
    """On the (data, model) ``shape`` mesh of ranks in order: the first
    step (``first``: loss, whole gradients, collectives), then ``STEPS``
    steps of the train step (``losses``, ``traces``) and the kernel
    launches of it all (``launches``); on ``placed``, the same ranks in
    that order, the first step again (``placed``)."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    if device == "cuda":     # the card run_world gave this rank
        device = torch.device("cuda", torch.cuda.current_device())
    cfg = config(arch)
    model = Model(cfg, device=device)
    ops.reset_launch_counts()
    axis, model_axis = _axes(device, shape, range(dist.get_world_size()))
    out = {"first": _first_step(model, axis, model_axis, device)}
    layout = dp.param_layout(model, axis, model_axis)
    params = layout.shard(weights(model))
    ocfg = opt_lib.OptConfig(lr=LR)
    step = dp.make_data_parallel_step(
        model, ocfg, opt_lib.warmup_cosine(LR, WARMUP, STEPS), axis,
        model_axis=model_axis)
    opt_state = opt_lib.init(ocfg, params)
    out["losses"], out["traces"] = [], []
    for s in range(STEPS):
        local = dp.shard_batch(cfg, CELL, batch(cfg, s, device), axis)
        with coll.record_collectives() as ops_:
            params, opt_state, metrics = step(params, opt_state, local)
        out["losses"].append(float(metrics["loss"]))
        out["traces"].append(list(ops_))
    out["launches"] = ops.launch_counts()
    if placed is not None:
        out["placed"] = _first_step(model, *_axes(device, shape, placed),
                                    device)
    return out


def one_device(arch, device="cpu"):
    """The one-device port step on the same global batches: the first
    step's loss and gradients by leaf (numpy), and every step's loss."""
    cfg = config(arch)
    model = Model(cfg, device=device)
    params = weights(model)
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


def numpy_weights(arch):
    """The weights as a tree of numpy arrays (for the reference)."""
    return tree_map(lambda p: p.numpy(),
                    weights(Model(config(arch), device="cpu")))
