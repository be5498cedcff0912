"""The expert-parallel, ``attn_dp`` and RWKV worlds of
``tests/test_torch_expert_parallel.py``: SMOKE configs in f32 with
overrides (16 experts, so that they shard over ``ep``), each case's
first step on a (data, model) mesh of the world's 4 gloo ranks -- loss,
whole gradients, collectives and K8 launches -- and, where asked, one
whole train step's collectives; and the one-device step they are held
to.  ``tests/test_torch_cuda.py`` runs the same ranks on the card.  Every
case runs in one world (a mesh per case over the same ranks), which
spares a spawn of 4 processes a case.  Kept out of the test module
(which imports JAX) so that the spawned ranks import torch and the port
only."""
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models.api import Model
from repro_torch.models.param import tree_flatten, tree_map, tree_unflatten
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import data_parallel as dp
from repro_torch.train import optimizer as opt_lib

import _torch_tp_world as tpw


def config(arch, overrides):
    """``arch``'s SMOKE config in f32 compute with ``overrides``."""
    return dataclasses.replace(configs.smoke_config(arch),
                               compute_dtype=torch.float32, **overrides)


def _case(arch, overrides, shape, whole_step, device):
    cfg = config(arch, overrides)
    model = Model(cfg, device=device)
    axis, model_axis = tpw._axes(device, shape,
                                 range(int(np.prod(shape))))
    before = ops.launch_counts()["selective_scan"]
    loss, grads, trace = tpw._first_step(model, axis, model_axis, device)
    out = {"loss": loss, "grads": grads, "trace": trace,
           "k8": ops.launch_counts()["selective_scan"] - before}
    if whole_step:
        params = dp.param_layout(model, axis, model_axis).shard(
            tpw.weights(model))
        ocfg = opt_lib.OptConfig(lr=tpw.LR)
        train_step = dp.make_data_parallel_step(
            model, ocfg, opt_lib.warmup_cosine(tpw.LR, tpw.WARMUP,
                                               tpw.STEPS), axis,
            model_axis=model_axis)
        first = dp.shard_batch(cfg, tpw.CELL, tpw.batch(cfg, 0, device),
                               axis)
        with coll.record_collectives() as ops_:
            train_step(params, opt_lib.init(ocfg, params), first)
        out["step_trace"] = list(ops_)
    return out


def ep_rank(world_mesh, cases, device="cpu"):
    """Each of ``cases`` -- ``(arch, overrides, (data, model) shape,
    whole_step)`` -- on this rank's ``device``: :func:`_case`'s first
    step (``loss``, whole ``grads``, ``trace``, K8 launches ``k8``) and,
    with ``whole_step``, one train step's collectives
    (``step_trace``)."""
    torch.set_num_threads(1)
    if device == "cuda":     # the card run_world gave this rank
        device = torch.device("cuda", torch.cuda.current_device())
    return [_case(*case, device) for case in cases]


def one_device(arch, overrides, dtype=torch.float32):
    """The one-device port's first step on the CPU: loss and gradients
    by leaf (numpy), the weights and compute cast to ``dtype``."""
    cfg = dataclasses.replace(config(arch, overrides), compute_dtype=dtype)
    model = Model(cfg, device="cpu")
    leaves, treedef = tree_flatten(tpw.weights(model))
    leaves = [p.to(dtype).detach().requires_grad_(True) for p in leaves]
    loss = model.loss(tree_unflatten(treedef, leaves), tpw.batch(cfg, 0))
    return float(loss.detach()), [
        g.numpy() for g in torch.autograd.grad(loss, leaves)]


def numpy_weights(arch, overrides):
    """The weights as a tree of numpy arrays (for the reference)."""
    return tree_map(lambda p: p.numpy(), tpw.weights(
        Model(config(arch, overrides), device="cpu")))
