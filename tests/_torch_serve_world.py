"""The serving worlds of ``tests/test_torch_serve_parallel.py`` (on the
CPU) and ``tests/test_torch_cuda.py`` (on the card): SMOKE configs in f32
with overrides on (data, model) meshes of a world's 4 gloo ranks, each
case's prefill and greedy decode steps through
``data_parallel.make_serve_steps`` -- whole logits, the cache
reassembled from every rank's part, the greedy tokens, the collectives
of each step and K8's launches -- and the one-device serving they are
held to.  Every case runs in one world (a mesh per case over the same
ranks).  Kept out of the test module (which imports JAX) so that the
spawned ranks import torch and the port only."""
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models.api import Model
from repro_torch.models.config import ShapeCell
from repro_torch.models.param import tree_flatten, tree_map
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import data_parallel as dp

import _torch_tp_world as tpw

# 4 prompts of 44 tokens, a cache of 52 positions, 5 greedy decode steps:
# Gemma3's 32-token ring (rolled by 44 % 32 = 12) takes the steps' keys in
# slots 12-16, across the boundary of two ranks' slices at (2, 2) and at
# (1, 4)
BATCH, PROMPT, CACHE_LEN, STEPS, SEED = 4, 44, 52, 5, 0


def config(arch, overrides):
    """``arch``'s SMOKE config in f32 compute with ``overrides``."""
    return dataclasses.replace(configs.smoke_config(arch),
                               compute_dtype=torch.float32, **overrides)


def prompt(cfg):
    """The prompts (BATCH, PROMPT) int32, from a seeded numpy generator."""
    return np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (BATCH, PROMPT), dtype=np.int32)


def cells():
    """The prefill and decode cells of a case (for ``shard_batch``,
    ``cache_layout`` and the lowering)."""
    return (ShapeCell("prefill", PROMPT, BATCH, "prefill"),
            ShapeCell("decode", CACHE_LEN, BATCH, "decode"))


def _whole(x, axis, model_axis):
    """A step's logits (B', V') whole: gathered over model, then data."""
    if model_axis is not None:
        x = coll.all_gather(x, model_axis, x.dim() - 1)
    return coll.all_gather(x, axis, 0).cpu().numpy()


def _case(arch, overrides, shape, device):
    cfg = config(arch, overrides)
    model = Model(cfg, device=device)
    axis, model_axis = tpw._axes(device, shape, range(int(np.prod(shape))))
    pcell, dcell = cells()
    params = dp.param_layout(model, axis, model_axis).shard(
        tpw.weights(model))
    batch = dp.shard_batch(cfg, pcell, {"tokens": torch.as_tensor(
        prompt(cfg), device=device)}, axis)
    prefill, decode = dp.make_serve_steps(model, axis, model_axis)
    layout = dp.cache_layout(model, dcell, axis, model_axis)
    before = ops.launch_counts()["selective_scan"]
    with coll.record_collectives() as ops_:
        logits, cache = prefill(params, batch, CACHE_LEN)
    out = {"prefill_trace": list(ops_), "decode_traces": [],
           "k8": ops.launch_counts()["selective_scan"] - before,
           "logits": [_whole(logits, axis, model_axis)],
           "cache": [c.cpu().numpy()
                     for c in tree_flatten(layout.gather(cache))[0]],
           "cache_shapes": [tuple(c.shape) for c in tree_flatten(cache)[0]]}
    tok = dp.greedy_tokens(logits, model_axis)
    tokens = [coll.all_gather(tok, axis, 0).cpu().numpy()]
    for t in range(STEPS):
        with coll.record_collectives() as ops_:
            logits, cache = decode(params, cache, {"tokens": tok[:, None]},
                                   PROMPT + t)
        out["decode_traces"].append(list(ops_))
        out["logits"].append(_whole(logits, axis, model_axis))
        tok = dp.greedy_tokens(logits, model_axis)
        tokens.append(coll.all_gather(tok, axis, 0).cpu().numpy())
    out["tokens"] = np.stack(tokens, axis=1)
    return out


def serve_rank(world_mesh, cases, device="cpu"):
    """Each of ``cases`` -- ``(arch, overrides, (data, model) shape)`` --
    on this rank's ``device``: :func:`_case`'s prefill and STEPS greedy
    decode steps (whole ``logits`` of each, the whole prefill ``cache``
    by leaf, this rank's ``cache_shapes``, ``tokens`` (BATCH, STEPS + 1),
    ``prefill_trace``, ``decode_traces`` and K8 launches ``k8``); then,
    for each distinct shape in sorted order, :func:`argmax_ties`."""
    torch.set_num_threads(1)
    if device == "cuda":     # the card run_world gave this rank
        device = torch.device("cuda", torch.cuda.current_device())
    out = [_case(*case, device) for case in cases]
    for shape in sorted({case[2] for case in cases}):
        _, model_axis = tpw._axes(device, shape, range(int(np.prod(shape))))
        out.append(argmax_ties(model_axis, device))
    return out


def one_device(arch, overrides, device="cpu", groups=1):
    """The one-device port's serving on the same prompts, the prefill's
    MoE routed in ``groups`` groups (a world's data-parallel width, as
    the reference's prefill): the logits of the prefill and of each
    greedy decode step, the prefill's cache by leaf and the greedy
    tokens (numpy)."""
    cfg = config(arch, overrides)
    model = Model(cfg, device=device)
    params = tpw.weights(model)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": torch.as_tensor(
            prompt(cfg), device=device)}, groups, CACHE_LEN)
        out = {"logits": [logits.cpu().numpy()],
               "cache": [c.cpu().numpy().copy()
                         for c in tree_flatten(cache)[0]]}
        tok = torch.argmax(logits, dim=-1)
        tokens = [tok.cpu().numpy()]
        for t in range(STEPS):
            logits, cache = model.decode_step(params, cache,
                                              {"tokens": tok[:, None]},
                                              PROMPT + t)
            out["logits"].append(logits.cpu().numpy())
            tok = torch.argmax(logits, dim=-1)
            tokens.append(tok.cpu().numpy())
    out["tokens"] = np.stack(tokens, axis=1)
    return out


def numpy_weights(arch, overrides):
    """The weights as a tree of numpy arrays (for the reference)."""
    return tree_map(lambda p: p.numpy(), tpw.weights(
        Model(config(arch, overrides), device="cpu")))


def argmax_ties(model_axis, device):
    """``greedy_tokens`` of logits whose largest value lies in several
    ranks' columns (and twice in one): (the tokens, the whole logits)."""
    m = 1 if model_axis is None else model_axis.size
    whole = torch.zeros((3, 8 * m), device=device)
    whole[0, [5, 8 * m - 1]] = 2.0            # the first wins
    whole[1, [8 * m - 3, 8 * m - 2]] = 1.0    # the last rank's first
    whole[2, :] = -1.0                        # all equal: index 0
    index = 0 if model_axis is None else model_axis.index
    local = whole[:, 8 * index:8 * (index + 1)]
    return dp.greedy_tokens(local, model_axis).cpu().numpy(), \
        whole.cpu().numpy()
