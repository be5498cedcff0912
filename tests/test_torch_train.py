"""The port's training path against the JAX package's, on the CPU.

Data, optimizers, the chunked LM loss, ``train_loss`` and its gradients
for every architecture the port serves, the train step, checkpoints
(the reference's files included), the elastic helpers, the int8
collectives and ``launch.train.train``.  Weights come from the reference
(``convert.lm_params_from_reference``), inputs from a seeded numpy
generator, and models compute in f32 except where a bf16 case is named.

Tolerances, against the reference's largest magnitude (per leaf for
trees): both sides run the same f32 arithmetic in the same order of
operations and differ in the order of the sums inside products and
reductions and in the last ulp of ``exp``/``log``/``cos`` (the reasons
of ``tests/test_torch_lm.py``).  So ``1e-6`` for one optimizer update
and the schedule, ``1e-5`` for a loss, ``1e-4`` for a whole model's
gradients, ``1e-5`` for losses and SGD-M weights over three train steps,
``1e-4`` for eight steps of ``launch.train.train``.  AdamW's first update
is about ``lr * sign(g)``, so a gradient at the noise floor can flip a
weight by ``2 lr``: AdamW weights are compared after one update of given
gradients only.  The bf16 train step holds losses to ``1e-2``: bf16
rounds at other places in the two frameworks.
"""
import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import configs as jconfigs
from repro.launch import elastic as jelastic
from repro.launch import train as jlaunch_train
from repro.models import layers as jlayers
from repro.models.api import Model as JModel
from repro.models.config import ModelConfig as JModelConfig
from repro.parallel import collectives as jcoll
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import step as jstep

from repro_torch import configs, convert
from repro_torch.kernels import ops
from repro_torch.launch import elastic, mesh as tmesh
from repro_torch.launch import train as launch_train
from repro_torch.launch.world import run_world
from repro_torch.models import layers
from repro_torch.models.api import Model, input_specs, make_concrete_batch
from repro_torch.models.transformer import FRONTEND_DIMS
from repro_torch.models.config import ShapeCell
from repro_torch.models.param import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.parallel import collectives, sharding
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_lib

import test_torch_train_world

F32 = dict(compute_dtype=jnp.float32)
ARCHS = configs.ARCH_IDS          # every architecture
B, S = 2, 64
# examples/train_lm.py's CFG_QUICK
QUICK = dict(name="lm-quick", num_layers=4, d_model=128, num_heads=4,
             num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=2048,
             layer_pattern="T" * 4, attn_q_chunk=32, attn_kv_chunk=64,
             loss_chunk=32)


@pytest.fixture(autouse=True, scope="module")
def _setup():
    """Two intra-op threads (several test processes share the host), and
    JAX's persistent compilation cache off: XLA on the CPU aborts while
    serialising the sharded LM train step (``tests/conftest.py`` does the
    same for the reference's own training tests)."""
    from jax._src import compilation_cache as cc
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", True)
    cc.reset_cache()
    torch.set_num_threads(threads)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    assert err <= tol * scale, f"{what}: max err {err} > {tol} * {scale}"


def _trees_close(got, want, tol):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        _close(a, b, tol, f"leaf {i}")


def _pair(jcfg, seed=0):
    """(reference params, port config, port params)."""
    jparams = JModel(jcfg).init(jax.random.PRNGKey(seed))
    tcfg = convert.model_config_from_reference(dataclasses.asdict(jcfg))
    tparams = convert.lm_params_from_reference(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jparams),
        param_dtype=tcfg.param_dtype)
    return jparams, tcfg, tparams


def _lm_batch(vocab, seed=1, b=B, s=S):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1)
                                                ).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _arch_batch(jcfg, seed=1):
    """``_lm_batch``, with ``embeds`` (B, S, fd) from the same seed's
    generator in place of ``tokens`` for a model with a frontend."""
    batch = _lm_batch(jcfg.vocab_size, seed)
    if jcfg.frontend is None:
        return batch
    fd = FRONTEND_DIMS[jcfg.frontend]
    emb = np.random.default_rng(seed + 1000).standard_normal(
        (B, S, fd)).astype(np.float32)
    return {"embeds": emb, "labels": batch["labels"]}


def _torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _port_loss_grads(tcfg, tparams, batch):
    """(loss, gradient leaves in the reference's order) of the port."""
    leaves, treedef = tree_flatten(tparams)
    leaves = [l.detach().requires_grad_(True) for l in leaves]
    loss = Model(tcfg, device="cpu").loss(tree_unflatten(treedef, leaves),
                                          _torch_batch(batch))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), [torch.zeros_like(l) if g is None else g
                           for l, g in zip(leaves, grads)]


# ---------------------------------------------------------------- data

@pytest.mark.parametrize("seed,step,procs,frontend", [
    (0, 0, 1, None), (3, 5, 2, None), (7, 123, 4, None), (11, 2, 8, None),
    (5, 9, 2, "audio")])
def test_batch_at_equals_reference_bit_for_bit(seed, step, procs, frontend):
    kw = dict(vocab_size=1000, seq_len=16, global_batch=8, seed=seed,
              frontend=frontend, frontend_dim=12 if frontend else 0)
    jcfg, tcfg = jdata.DataConfig(**kw), data.DataConfig(**kw)
    for index in range(procs):
        want = jdata.batch_at(jcfg, step, index, procs)
        got = data.batch_at(tcfg, step, index, procs)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    stream = data.stream(tcfg, start_step=step)
    np.testing.assert_array_equal(next(stream)["labels"],
                                  jdata.batch_at(jcfg, step)["labels"])
    moved = data.to_device(data.batch_at(tcfg, step), "cpu")
    assert all(isinstance(v, torch.Tensor) for v in moved.values())


def test_host_slice_equals_reference():
    cfg = data.DataConfig(vocab_size=10, seq_len=4, global_batch=12)
    jcfg = jdata.DataConfig(vocab_size=10, seq_len=4, global_batch=12)
    for procs in (1, 2, 3, 4, 6, 12):
        for i in range(procs):
            assert data.host_slice(cfg, i, procs) == \
                jdata.host_slice(jcfg, i, procs)
    with pytest.raises(ValueError):
        data.host_slice(cfg, 0, 5)


# ---------------------------------------------------------------- optimizer

def _opt_tree(rng, scale=1.0):
    return {"b": [rng.standard_normal((5, 3)).astype(np.float32) * scale,
                  rng.standard_normal((7,)).astype(np.float32) * scale],
            "a": {"w": rng.standard_normal((4, 6)).astype(np.float32) * scale}}


@pytest.mark.parametrize("kind,moments,clip", [
    ("adamw", "float32", 1.0), ("adamw", "float32", 0.0),
    ("adamw", "bfloat16", 1.0), ("sgdm", "float32", 1.0),
    ("sgdm", "bfloat16", 0.0)])
def test_optimizer_updates_equal_reference(kind, moments, clip):
    """Three updates fed the same params and gradients on both sides:
    params and moments after each within 1e-6 relative."""
    rng = np.random.default_rng(0)
    params = _opt_tree(rng)
    grads = [_opt_tree(rng, 0.5) for _ in range(3)]
    kw = dict(kind=kind, lr=1e-2, weight_decay=0.1, grad_clip=clip)
    jcfg = jopt.OptConfig(**kw, moment_dtype=getattr(jnp, moments))
    tcfg = opt.OptConfig(**kw, moment_dtype=getattr(torch, moments))
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.as_tensor, params)
    jst, tst = jopt.init(jcfg, jp), opt.init(tcfg, tp)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1) / 3
        jp, jst = jopt.apply(jcfg, jnp.float32(lr), jp,
                             jax.tree.map(jnp.asarray, g), jst)
        tp, tst = opt.apply(tcfg, torch.tensor(lr, dtype=torch.float32), tp,
                            jax.tree.map(torch.as_tensor, g), tst)
        _trees_close(tp, jp, 1e-6)
        _trees_close(tst.mu, jst.mu, 1e-6)
        _trees_close(tst.nu, jst.nu, 1e-6)
        assert int(tst.step) == int(jst.step) == i + 1
        assert all(l.dtype == getattr(torch, moments)
                   for l in tree_leaves(tst.mu))


def test_global_norm_and_clip_equal_reference():
    rng = np.random.default_rng(1)
    tree = _opt_tree(rng, 3.0)
    jt, tt = jax.tree.map(jnp.asarray, tree), jax.tree.map(torch.as_tensor,
                                                           tree)
    _close(opt.global_norm(tt), jopt.global_norm(jt), 1e-6)
    for max_norm in (0.5, 1.0, 1e3):
        jc, jn = jopt.clip_by_global_norm(jt, max_norm)
        tc, tn = opt.clip_by_global_norm(tt, max_norm)
        _close(tn, jn, 1e-6)
        _trees_close(tc, jc, 1e-6)


@pytest.mark.parametrize("lr,warmup,total,floor", [
    (3e-4, 50, 300, 0.1), (1e-3, 0, 40, 0.1), (1e-2, 7, 7, 0.3),
    (2.5e-3, 3, 20, 0.0)])
def test_warmup_cosine_equals_reference(lr, warmup, total, floor):
    jsched = jopt.warmup_cosine(lr, warmup, total, floor)
    tsched = opt.warmup_cosine(lr, warmup, total, floor)
    for s in range(total + 1):
        _close(tsched(torch.tensor(s, dtype=torch.int32)),
               jsched(jnp.int32(s)), 1e-6, f"step {s}")


def test_abstract_state_is_meta():
    m = Model(configs.smoke_config("qwen3_4b"), device="cpu")
    st = opt.abstract_state(opt.OptConfig(moment_dtype=torch.bfloat16),
                            m.abstract())
    leaves = tree_leaves(st)
    assert all(l.device.type == "meta" for l in leaves)
    assert st.step.dtype == torch.int32 and st.step.shape == ()
    assert [tuple(l.shape) for l in tree_leaves(st.mu)] == \
        [tuple(l.shape) for l in tree_leaves(m.abstract())]


# ---------------------------------------------------------------- the loss

@pytest.mark.parametrize("chunk", [16, 64])
def test_lm_loss_equals_reference(chunk):
    jcfg = jconfigs.smoke_config("qwen3_4b").with_overrides(loss_chunk=chunk,
                                                            **F32)
    tcfg = convert.model_config_from_reference(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(2)
    h = rng.standard_normal((B, S, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 256)) / 8).astype(np.float32)
    t = rng.integers(0, 256, (B, S)).astype(np.int32)
    want = jlayers.lm_loss({"w": jnp.asarray(w)}, jnp.asarray(h),
                           jnp.asarray(t), jcfg)
    got = layers.lm_loss({"w": torch.as_tensor(w)}, torch.as_tensor(h),
                         torch.as_tensor(t), tcfg)
    _close(got, want, 1e-5)
    whole = layers.lm_loss({"w": torch.as_tensor(w)}, torch.as_tensor(h),
                           torch.as_tensor(t),
                           tcfg.with_overrides(loss_chunk=S))
    _close(got, whole, 1e-6, "chunked vs unchunked")
    with pytest.raises(ValueError):
        layers.lm_loss({"w": torch.as_tensor(w)}, torch.as_tensor(h[:, :60]),
                       torch.as_tensor(t[:, :60]), tcfg.with_overrides(
                           loss_chunk=16))


@functools.lru_cache(maxsize=None)
def _arch_grads(arch):
    """One architecture at SMOKE width in f32: the reference's loss and
    gradients, and the port's."""
    jcfg = jconfigs.smoke_config(arch).with_overrides(**F32)
    jparams, tcfg, tparams = _pair(jcfg)
    batch = _arch_batch(jcfg)
    jl, jg = jax.jit(jax.value_and_grad(JModel(jcfg).loss))(
        jparams, jax.tree.map(jnp.asarray, batch))
    ops.reset_launch_counts()
    tl, tg = _port_loss_grads(tcfg, tparams, batch)
    return arch, tcfg, tparams, batch, (jl, jg), (tl, tg)


@pytest.fixture(scope="module", params=ARCHS)
def arch_grads(request):
    return _arch_grads(request.param)


def test_train_loss_and_grads_equal_reference(arch_grads):
    arch, _, _, _, (jl, jg), (tl, tg) = arch_grads
    _close(tl, jl, 1e-5, f"{arch} loss")
    want = jax.tree.leaves(jg)
    assert len(tg) == len(want)
    for i, (g, w) in enumerate(zip(tg, want)):
        _close(g, w, 1e-4, f"{arch} grad leaf {i}")


def test_every_mamba_weight_gets_its_gradient():
    """Jamba's Mamba weights: every one has a nonzero gradient (the scan's
    gradient flows through ``SelectiveScan``), equal to the reference's."""
    jcfg = jconfigs.smoke_config("jamba_v0_1_52b").with_overrides(**F32)
    jparams, tcfg, tparams = _pair(jcfg)
    batch = _lm_batch(jcfg.vocab_size)
    jg = jax.jit(jax.grad(JModel(jcfg).loss))(
        jparams, jax.tree.map(jnp.asarray, batch))
    leaves, treedef = tree_flatten(tparams)
    leaves = [l.detach().requires_grad_(True) for l in leaves]
    tree = tree_unflatten(treedef, leaves)
    loss = Model(tcfg, device="cpu").loss(tree, _torch_batch(batch))
    loss.backward()
    mixers = [(i, p["mixer"]) for i, (ch, p) in
              enumerate(zip(jcfg.layer_pattern, tree["unit"])) if ch in "mM"]
    assert len(mixers) == 7
    for i, mixer in mixers:
        assert sorted(mixer) == sorted(jg["unit"][i]["mixer"])
        for name, p in mixer.items():
            assert p.grad is not None and bool(p.grad.abs().max() > 0), \
                (i, name)
            _close(p.grad, jg["unit"][i]["mixer"][name], 1e-4, f"{i} {name}")


def test_every_rwkv_weight_gets_its_gradient():
    """RWKV6's time-mix and channel-mix weights in both stacked layers:
    every one has a nonzero gradient (the decay's low-rank factors and
    the bonus included), equal to the reference's."""
    _, _, tparams, _, (_, jg), (_, tg) = _arch_grads("rwkv6_7b")
    tree = tree_unflatten(tree_flatten(tparams)[1], tg)
    tm, want = tree["unit"][0]["tm"], jg["unit"][0]["tm"]
    assert sorted(tm) == sorted(want) and len(tm) == 20
    for name, g in tm.items():
        assert g.shape[0] == 2, name                  # "RR": two layers
        for layer in range(2):
            assert bool(g[layer].abs().max() > 0), (name, layer)
        _close(g, want[name], 1e-4, name)


@pytest.mark.parametrize("arch", ["qwen3_4b", "jamba_v0_1_52b", "gemma3_4b",
                                  "rwkv6_7b", "musicgen_medium",
                                  "internvl2_76b"])
def test_remat_modes_give_the_same_gradients(arch):
    """``none``, ``full`` and ``dots`` change what the backward keeps,
    never the numbers."""
    jcfg = jconfigs.smoke_config(arch).with_overrides(**F32)
    _, tcfg, tparams = _pair(jcfg)
    batch = _arch_batch(jcfg, seed=3)
    base_loss, base = _port_loss_grads(tcfg.with_overrides(remat="none"),
                                       tparams, batch)
    for mode in ("full", "dots"):
        loss, grads = _port_loss_grads(tcfg.with_overrides(remat=mode),
                                       tparams, batch)
        assert torch.equal(loss, base_loss), mode
        for i, (g, b) in enumerate(zip(grads, base)):
            assert torch.equal(g, b), (mode, i)


def test_selective_scan_grad_equals_autograd_of_plain_scan():
    """``ops.selective_scan`` on the CPU: outputs and every input's
    gradient equal those of autograd through the plain scan itself."""
    from repro_torch.kernels.selective_scan import selective_scan_plain
    rng = np.random.default_rng(4)
    shape = dict(u=(2, 9, 6), dt=(2, 9, 6), a=(6, 4), b=(2, 9, 4),
                 c=(2, 9, 4))
    vals = {k: rng.standard_normal(v).astype(np.float32) * 0.5
            for k, v in shape.items()}
    vals["dt"] = np.abs(vals["dt"]) * 0.1
    vals["a"] = -np.abs(vals["a"])
    gy = rng.standard_normal((2, 9, 6)).astype(np.float32)
    gh = rng.standard_normal((2, 6, 4)).astype(np.float32)

    def run(fn):
        xs = [torch.tensor(vals[k], requires_grad=True) for k in shape]
        y, h = fn(*xs)
        torch.autograd.backward([y, h], [torch.as_tensor(gy),
                                         torch.as_tensor(gh)])
        return y.detach(), h.detach(), [x.grad for x in xs]

    y0, h0, g0 = run(selective_scan_plain)
    y1, h1, g1 = run(ops.selective_scan)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- api

def test_input_specs_and_concrete_batch_match_reference():
    from repro.models.api import input_specs as jinput_specs
    from repro.models.api import make_concrete_batch as jmake_batch
    from repro.models.config import ShapeCell as JShapeCell
    for arch in ("qwen3_4b", "musicgen_medium", "internvl2_76b"):
        for kind, seq, batch in (("train", 32, 4), ("prefill", 16, 2),
                                 ("decode", 64, 3)):
            jcfg, tcfg = jconfigs.smoke_config(arch), configs.smoke_config(arch)
            want = jinput_specs(jcfg, JShapeCell("c", seq, batch, kind))
            cell = ShapeCell("c", seq, batch, kind)
            got = input_specs(tcfg, cell)
            assert sorted(got) == sorted(want)
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert str(got[k].dtype).split(".")[-1] == \
                    str(want[k].dtype)
                assert got[k].device.type == "meta"
            real = make_concrete_batch(tcfg, cell,
                                       torch.Generator().manual_seed(0))
            jreal = jmake_batch(jcfg, JShapeCell("c", seq, batch, kind),
                                jax.random.PRNGKey(0))
            for k in want:
                assert real[k].shape == got[k].shape
                assert real[k].dtype == got[k].dtype
                if not real[k].dtype.is_floating_point:
                    assert int(real[k].min()) >= 0 and \
                        int(real[k].max()) < tcfg.vocab_size
                    assert int(jreal[k].min()) >= 0
                else:
                    assert bool(torch.isfinite(real[k].float()).all())


def test_model_abstract_matches_reference():
    for arch in ARCHS:
        jm = JModel(jconfigs.smoke_config(arch))
        tm = Model(configs.smoke_config(arch), device="cpu")
        want = [(tuple(x.shape), str(x.dtype)) for x in
                jax.tree.leaves(jm.abstract())]
        got = [(tuple(x.shape), str(x.dtype).split(".")[-1])
               for x in tree_leaves(tm.abstract())]
        assert got == want, arch
        cache = tm.abstract_cache(2, 16)
        wcache = jm.abstract_cache(2, 16)
        assert [tuple(x.shape) for x in tree_leaves(cache)] == \
            [tuple(x.shape) for x in jax.tree.leaves(wcache)], arch


# ---------------------------------------------------------------- train step

QWEN = "qwen3_4b"
DATA = dict(seq_len=32, global_batch=4, seed=7)


@pytest.fixture(scope="module")
def qwen_pair():
    return _pair(jconfigs.smoke_config(QWEN).with_overrides(**F32))


def _run_steps(jcfg, jparams, tcfg, tparams, okw, mb, steps=3):
    """``steps`` train steps of the reference (jitted) and of the port on
    the data pipeline's batches: their metrics and final params."""
    jocfg = jopt.OptConfig(**okw)
    tocfg = opt.OptConfig(**okw)
    sched = dict(lr=okw["lr"], warmup=1, total=10)
    jfn = jax.jit(jstep.make_train_step(JModel(jcfg), jocfg,
                                        jopt.warmup_cosine(**sched),
                                        microbatch=mb))
    tfn = step_lib.make_train_step(Model(tcfg, device="cpu"), tocfg,
                                   opt.warmup_cosine(**sched), microbatch=mb)
    dcfg = data.DataConfig(vocab_size=jcfg.vocab_size, **DATA)
    jp, jst = jparams, jopt.init(jocfg, jparams)
    tp, tst = tparams, opt.init(tocfg, tparams)
    jm, tm = [], []
    for s in range(steps):
        batch = data.batch_at(dcfg, s)
        jp, jst, m = jfn(jp, jst, jax.tree.map(jnp.asarray, batch))
        jm.append({k: float(v) for k, v in m.items()})
        tp, tst, m = tfn(tp, tst, data.to_device(batch, "cpu"))
        tm.append({k: float(v) for k, v in m.items()})
    return jm, tm, jp, tp


@pytest.mark.parametrize("kind,mb", [("adamw", 1), ("sgdm", 1), ("sgdm", 2),
                                     ("adamw", 2)])
def test_train_step_equals_reference(qwen_pair, kind, mb):
    jparams, tcfg, tparams = qwen_pair
    jcfg = jconfigs.smoke_config(QWEN).with_overrides(**F32)
    okw = dict(kind=kind, lr=1e-3) if kind == "adamw" else \
        dict(kind=kind, lr=1e-2, weight_decay=0.0, grad_clip=0.0)
    jm, tm, jp, tp = _run_steps(jcfg, jparams, tcfg, tparams, okw, mb)
    for s, (a, b) in enumerate(zip(tm, jm)):
        assert a["step"] == b["step"] == s + 1
        for k in ("loss", "grad_norm", "lr"):
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), (s, k, a[k], b[k])
    if kind == "sgdm":
        _trees_close(tp, jp, 1e-5)


def test_microbatched_step_equals_plain_step(qwen_pair):
    jparams, tcfg, tparams = qwen_pair
    jcfg = jconfigs.smoke_config(QWEN).with_overrides(**F32)
    okw = dict(kind="sgdm", lr=1e-2, weight_decay=0.0, grad_clip=0.0)
    _, t1, _, p1 = _run_steps(jcfg, jparams, tcfg, tparams, okw, 1)
    _, t2, _, p2 = _run_steps(jcfg, jparams, tcfg, tparams, okw, 2)
    for a, b in zip(t2, t1):
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]), (k, a[k], b[k])
    g, w = tree_leaves(p2), tree_leaves(p1)
    for i, (a, b) in enumerate(zip(g, w)):
        _close(a, b, 1e-5, f"leaf {i}")


def test_bf16_train_step_equals_reference():
    jcfg = jconfigs.smoke_config(QWEN)
    jparams, tcfg, tparams = _pair(jcfg)
    assert tcfg.compute_dtype == torch.bfloat16
    jm, tm, _, _ = _run_steps(jcfg, jparams, tcfg, tparams,
                              dict(kind="adamw", lr=1e-3), 1)
    for a, b in zip(tm, jm):
        assert abs(a["loss"] - b["loss"]) <= 1e-2 * abs(b["loss"]), (a, b)
    assert tm[-1]["loss"] < tm[0]["loss"]


def test_serve_steps_are_the_model_entry_points(qwen_pair):
    _, tcfg, tparams = qwen_pair
    model = Model(tcfg, device="cpu")
    toks = torch.as_tensor(_lm_batch(tcfg.vocab_size)["tokens"])
    logits, cache = step_lib.make_prefill_step(model)(tparams,
                                                      {"tokens": toks})
    want, _ = model.prefill(tparams, {"tokens": toks})
    assert torch.equal(logits, want)
    cache = model.make_cache(B, 8)
    out, _ = step_lib.make_decode_step(model)(tparams, cache,
                                              {"tokens": toks[:, :1]}, 0)
    want, _ = model.decode_step(tparams, model.make_cache(B, 8),
                                {"tokens": toks[:, :1]}, 0)
    assert torch.equal(out, want)


# ---------------------------------------------------------------- checkpoints

def test_checkpoint_roundtrip(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), cfg_hash="h1")
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.tensor(7, dtype=torch.int32),
                  "d": [torch.tensor([1.5, -2.25], dtype=torch.bfloat16)]}}
    mgr.save(10, tree, blocking=True)
    assert mgr.latest_step() == 10
    back = mgr.restore(10, tree)
    for x, y in zip(tree_leaves(tree), tree_leaves(back)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    # the reference's layout: leaves in jax's order, the manifest's dtypes
    import json
    with open(tmp_path / "step_00000010" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["dtypes"] == ["float32", "int32", "bfloat16"]
    assert manifest["shapes"] == [[2, 3], [], [2]]
    assert np.load(tmp_path / "step_00000010" / "leaf_00002.npy").dtype == \
        np.dtype("V2")


def test_checkpoint_atomicity_and_gc(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2)
    tree = {"w": torch.ones(4)}
    for s in [1, 2, 3, 4]:
        mgr.save(s, tree, blocking=True)
    assert mgr.all_steps() == [3, 4]          # gc keeps 2
    # a stray tmp dir (a crash mid-write) is not trusted
    os.makedirs(tmp_path / "step_00000099.tmp" / "x", exist_ok=True)
    assert mgr.latest_step() == 4
    # nor a directory without its manifest
    os.makedirs(tmp_path / "step_00000100")
    assert mgr.latest_step() == 4


def test_checkpoint_hash_mismatch(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), cfg_hash="AAAA")
    tree = {"w": torch.ones(2)}
    mgr.save(1, tree, blocking=True)
    with pytest.raises(ValueError):
        ckpt.CheckpointManager(str(tmp_path), cfg_hash="BBBB").restore(1, tree)
    with pytest.raises(ValueError):
        mgr.restore(1, {"w": torch.ones(2), "v": torch.ones(1)})
    assert ckpt.config_hash(("x", 1)) == jckpt.config_hash(("x", 1))


def test_resume_after_kill_matches_uninterrupted(tmp_path):
    """Train 4 steps; or train 2, save, restore into a fresh tree, train
    2: the same weights, bit for bit."""
    cfg = configs.smoke_config("qwen1_5_4b")
    model = Model(cfg, device="cpu")
    ocfg = opt.OptConfig(lr=1e-3)
    fn = step_lib.make_train_step(model, ocfg, opt.warmup_cosine(1e-3, 0, 100))
    dcfg = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                           global_batch=4, seed=7)

    def run(params, st, s0, s1):
        for s in range(s0, s1):
            params, st, _ = fn(params, st, data.to_device(data.batch_at(dcfg, s),
                                                          "cpu"))
        return params, st

    pa, sa = run(model.init(seed=0), opt.init(ocfg, model.init(seed=0)), 0, 4)
    mgr = ckpt.CheckpointManager(str(tmp_path))
    pb, sb = run(model.init(seed=0), opt.init(ocfg, model.init(seed=0)), 0, 2)
    mgr.save(2, {"params": pb, "opt": sb}, blocking=True)
    like = {"params": model.abstract(),
            "opt": opt.abstract_state(ocfg, model.abstract())}
    restored = mgr.restore(2, like)
    assert isinstance(restored["opt"], opt.OptState)
    pb, sb = run(restored["params"], restored["opt"], 2, 4)
    for a, b in zip(tree_leaves((pa, sa)), tree_leaves((pb, sb))):
        assert torch.equal(a, b)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """Params and an ``OptState`` written by the reference's manager (one
    leaf in bf16, written through ml_dtypes as ``<V2``) restore into the
    port's tree: the same structure, dtypes and values."""
    jcfg = jconfigs.smoke_config("jamba_v0_1_52b")
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    jparams["final_norm"]["scale"] = (
        jparams["final_norm"]["scale"] * 1.37).astype(jnp.bfloat16)
    jocfg = jopt.OptConfig()
    jst = jopt.init(jocfg, jparams)
    jst = jst._replace(step=jnp.int32(5))
    tree = {"params": jparams, "opt": jst}
    jckpt.CheckpointManager(str(tmp_path), cfg_hash="ref").save(
        5, tree, blocking=True)
    with open(tmp_path / "step_00000005" / "leaf_00000.npy", "rb") as f:
        assert f.read(8) == b"\x93NUMPY\x01\x00"
    tcfg = configs.smoke_config("jamba_v0_1_52b")
    m = Model(tcfg, device="cpu")
    like = {"params": m.abstract(),
            "opt": opt.abstract_state(opt.OptConfig(), m.abstract())}
    mgr = ckpt.CheckpointManager(str(tmp_path), cfg_hash="ref")
    assert mgr.latest_step() == 5
    back = mgr.restore(5, like)
    assert isinstance(back["opt"], opt.OptState)
    assert int(back["opt"].step) == 5 and back["opt"].step.dtype == torch.int32
    got, want = tree_leaves(back), jax.tree.leaves(tree)
    assert len(got) == len(want)
    n_bf16 = 0
    for g, w in zip(got, want):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        n_bf16 += g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))
    assert n_bf16 == 1
    assert back["params"]["final_norm"]["scale"].dtype == torch.bfloat16


def test_opt_state_from_reference():
    jcfg = jconfigs.smoke_config("qwen3_4b")
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    for kind, dt in (("adamw", jnp.float32), ("sgdm", jnp.bfloat16)):
        jst = jopt.init(jopt.OptConfig(kind=kind, moment_dtype=dt), jparams)
        st = convert.opt_state_from_reference(
            jax.tree.map(lambda x: np.asarray(x, np.float32), jst),
            moment_dtype="bf16" if dt == jnp.bfloat16 else None)
        assert isinstance(st, opt.OptState) and st.step.dtype == torch.int32
        for g, w in zip(tree_leaves(st), jax.tree.leaves(jst)):
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
            assert tuple(g.shape) == tuple(w.shape)


# ---------------------------------------------------------------- elastic

def test_largest_feasible_shape_equals_reference():
    for n in range(1, 70):
        for model_axis in (1, 2, 4, 8, 16):
            try:
                want = jelastic.largest_feasible_shape(n, model_axis)
            except ValueError:
                with pytest.raises(ValueError):
                    elastic.largest_feasible_shape(n, model_axis)
                continue
            assert elastic.largest_feasible_shape(n, model_axis) == want


def test_remesh_takes_the_reference_shape():
    for n, model_axis in ((1, 1), (7, 2), (12, 4), (9, 1)):
        m = elastic.remesh(["cpu"] * n, model_axis)
        want = jelastic.largest_feasible_shape(n, model_axis)
        assert tuple(m.shape.values()) == want
        assert m.axis_names == ("data", "model")
    ref = jelastic.remesh(jax.devices()[:1], 1)
    assert tuple(ref.shape.values()) == tuple(
        elastic.remesh(["cpu"], 1).shape.values())


def test_watchdog_equals_reference():
    rng = np.random.default_rng(5)
    for trial in range(20):
        kw = dict(timeout_s=float(rng.uniform(1, 20)))
        jw, tw = jelastic.Watchdog(**kw), elastic.Watchdog(**kw)
        for h in range(int(rng.integers(1, 9))):
            t = float(rng.uniform(0, 30))
            jw.beat(h, now=t)
            tw.beat(h, now=t)
        now = float(rng.uniform(20, 40))
        assert tw.failed_hosts(now=now) == jw.failed_hosts(now=now)
        for factor in (1.5, 3.0):
            assert tw.straggler_hosts(factor, now=now) == \
                jw.straggler_hosts(factor, now=now)


# ---------------------------------------------------------------- collectives

def test_quantize_int8_equals_reference_bit_for_bit():
    rng = np.random.default_rng(6)
    for shape, scale in (((1000,), 1.0), ((13, 7), 1e-3), ((4,), 0.0)):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        if x.size > 3:
            x.flat[:3] = [0.5, -0.5, 1.5]      # ties round half to even
        jq, js = jcoll.quantize_int8(jnp.asarray(x))
        tq, ts = collectives.quantize_int8(torch.as_tensor(x))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(
            collectives.dequantize_int8(tq, ts).numpy(),
            np.asarray(jcoll.dequantize_int8(jq, js)))


def test_compressed_allreduce_mean_on_four_gloo_ranks_equals_reference():
    rng = np.random.default_rng(7)
    shards = rng.standard_normal((4, 6, 5)).astype(np.float32)
    errs = (rng.standard_normal((4, 6, 5)) * 1e-2).astype(np.float32)
    fn = jax.vmap(lambda g, e: jcoll.compressed_allreduce_mean(g, e, "d"),
                  axis_name="d")
    want_mean, want_err = fn(jnp.asarray(shards), jnp.asarray(errs))
    ranks = run_world(test_torch_train_world.allreduce_rank, 4,
                      device_type="cpu", args=(shards, errs), timeout_s=120)
    for r, (mean, err) in enumerate(ranks):
        np.testing.assert_allclose(mean, np.asarray(want_mean[r]), rtol=0,
                                   atol=1e-7)
        np.testing.assert_array_equal(err, np.asarray(want_err[r]))


# ---------------------------------------------------------------- launcher

def test_launch_train_equals_reference(tmp_path):
    """``launch.train.train`` on examples/train_lm.py's CFG_QUICK in f32,
    8 steps: the reference from ``PRNGKey(0)``, the port from the same
    weights and optimizer state written by the reference's checkpoint
    manager as step 0 (which the port's launcher resumes from)."""
    jcfg = JModelConfig(**QUICK, **F32)
    tcfg = convert.model_config_from_reference(dataclasses.asdict(jcfg))
    kw = dict(steps=8, global_batch=4, seq_len=64, lr=1e-3, warmup=2,
              log_every=1)
    want = jlaunch_train.train(jcfg, **kw)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    jst = jopt.init(jopt.OptConfig(lr=1e-3), jparams)
    jckpt.CheckpointManager(str(tmp_path)).save(
        0, {"params": jparams, "opt": jst}, blocking=True)
    got = launch_train.train(tcfg, checkpoint_dir=str(tmp_path),
                             checkpoint_every=4, device="cpu", **kw)
    assert [h["step"] for h in got["history"]] == \
        [h["step"] for h in want["history"]] == list(range(1, 9))
    for a, b in zip(got["history"], want["history"]):
        for k in ("loss", "grad_norm"):
            assert abs(a[k] - b[k]) <= 1e-4 * abs(b[k]), (a, b)
    assert got["placement"] is None and want["placement"] is None
    assert ckpt.CheckpointManager(str(tmp_path)).all_steps() == [0, 4, 8]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_every_config_splits_over_the_production_mesh(arch):
    """At published width every configuration passes ``check_mesh`` on
    the production (16, 16) mesh: its experts, RWKV heads and attention
    columns split whole over the model axis."""
    sharding.check_mesh(collectives.MetaMesh((16, 16), ("data", "model")),
                        configs.get_config(arch))


def test_launch_train_runs_on_one_device_only():
    """One device, data parallelism (``tests/test_torch_placement_job.py``
    trains a (4, 1) world) or a model axis above 1
    (``tests/test_torch_tensor_parallel.py`` and
    ``tests/test_torch_expert_parallel.py`` train (2, 2) and (1, 4)
    worlds).  A model whose experts over ep, RWKV heads or attention
    columns do not split whole over the model axis raises before any
    world starts."""
    cfg = configs.smoke_config("qwen3_4b")
    three = tmesh.make_mesh_with_devices(["cpu"] * 3, (1, 3),
                                         ("data", "model"))
    kw = dict(steps=1, global_batch=2, seq_len=16, mesh=three)
    with pytest.raises(ValueError, match="4 RWKV heads"):
        launch_train.train(configs.smoke_config("rwkv6_7b"), **kw)
    ep = configs.smoke_config("qwen3_moe_235b_a22b").with_overrides(
        num_experts=16)
    with pytest.raises(ValueError, match="16 experts"):
        launch_train.train(ep, placement="psa", **kw)
    with pytest.raises(ValueError, match="heads"):
        launch_train.train(cfg.with_overrides(attn_dp=True), **kw)
    with pytest.raises(ValueError, match="heads"):
        launch_train.train(cfg, steps=1, global_batch=2, seq_len=16,
                           mesh=tmesh.make_mesh_with_devices(
                               ["cpu"] * 6, (2, 3), ("data", "model")))
    one = tmesh.make_mesh_with_devices(["cpu"], (1, 1), ("data", "model"))
    out = launch_train.train(cfg, steps=2, global_batch=2, seq_len=16,
                             mesh=one, placement="psa", log_every=1)
    assert out["placement"] is None and len(out["history"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.train(cfg, steps=1, global_batch=2, seq_len=16)
