"""The port's LM serving stack against the JAX package's, on the CPU.

Jamba's ``SMOKE`` configuration (``mMmMaMmM``, one super-block), a
16-layer variant (the pattern twice, so ``layer_plan`` stacks the unit
with ``reps=2``), Gemma3's (windowed layers with a ring cache), RWKV6's
(``RR``: the RWKV block stacked, its cache a state) and the frontend
models' (MusicGen's audio and InternVL2's vision input, from ``tokens``
and from ``embeds``), with ``compute_dtype=float32`` for tight
comparisons;
weights drawn by the reference and carried over by
``convert.lm_params_from_reference``; inputs from
``numpy.random.default_rng``.

Tolerances, each against the largest magnitude of the reference's value:
``1e-5`` for one module and ``1e-4`` for the whole model's logits and
caches.  Both sides run the same f32 arithmetic in the same order of
operations; they differ in the order of the sums inside matrix products
and einsums and in the last ulp of ``exp``/``log``/``sin``/``cos``,
which leaves module outputs within ``1e-6`` and the 16-layer model's
logits within ``2e-6`` of each other (relative to the maximum).

The bf16 cases (the default ``SMOKE``) hold the JAX serving test's bar
(``tests/test_serve.py``: 0.15 absolute and relative, argmax agreement
>= 0.95): the port's prefill and decode logits against the reference's,
and the port's decode against teacher forcing.  bf16 rounds at other
places in the two frameworks (XLA keeps some fused chains of
elementwise ops in f32 and rounds once, PyTorch rounds after each op);
the port rounds its Mamba conv once, as the reference's fused code does,
and its RWKV block where the reference's does
(``tests/test_torch_rwkv.py``).
"""
import dataclasses
import io
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.models.api import Model as JModel
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig

from repro_torch import configs, convert
from repro_torch.core import keys
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers, moe, ssm, transformer
from repro_torch.models.api import Model
from repro_torch.models.param import tree_map
from repro_torch.serve import Engine, ServeConfig

ARCH = "jamba_v0_1_52b"
F32 = dict(compute_dtype=jnp.float32)
# name -> (arch, overrides of its SMOKE config).  "jamba-shape" keeps
# the narrow width but takes the full config's d_state 16, conv width 4,
# 16 experts and 4:1 grouped-query heads.  Gemma3's local layers (window
# 32, shorter than the 48-token prompts) run the ring cache.
CASES = {"smoke": (ARCH, F32),
         "deep": (ARCH, dict(F32, num_layers=16, layer_pattern="mMmMaMmM" * 2)),
         "jamba-shape": (ARCH, dict(F32, mamba_d_state=16, mamba_d_conv=4,
                                    num_experts=16, num_heads=8,
                                    num_kv_heads=2, head_dim=32)),
         "gemma3": ("gemma3_4b", F32),
         "rwkv": ("rwkv6_7b", F32),
         "musicgen": ("musicgen_medium", F32),
         "internvl2": ("internvl2_76b", F32)}
MODULE_TOL, MODEL_TOL = 1e-5, 1e-4
B, S, NEW = 2, 48, 8


def _flat(tree):
    """Leaves of a tree of dicts and lists, dict keys sorted (jax's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    assert err <= tol * scale, f"{what}: max err {err} > {tol} * {scale}"


def _trees_close(got, want, tol):
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        _close(a, b, tol, f"leaf {i}")


def _pair(jcfg):
    """(reference params, port config, port params) for a reference config."""
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    tcfg = convert.model_config_from_reference(dataclasses.asdict(jcfg))
    tparams = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, jparams), param_dtype=tcfg.param_dtype)
    return jparams, tcfg, tparams


@pytest.fixture(scope="module")
def smoke_params():
    return _pair(jconfigs.smoke_config(ARCH).with_overrides(**F32))


def _tokens(vocab, seed=1):
    return np.random.default_rng(seed).integers(
        2, vocab, (B, S + 1)).astype(np.int32)


@pytest.fixture(scope="module", params=sorted(CASES))
def lm(request):
    """One configuration run through the reference engine's jitted
    prefill and decode, and its generate."""
    arch, over = CASES[request.param]
    jcfg = jconfigs.smoke_config(arch).with_overrides(**over)
    jparams, tcfg, tparams = _pair(jcfg)
    toks = _tokens(jcfg.vocab_size)
    jeng = JEngine(JModel(jcfg), jparams, JServeConfig(max_new_tokens=NEW))
    logits, cache = jeng._prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])},
                                  cache_len=S + NEW)
    dlogits, dcache = jeng._decode(jparams, cache,
                                   {"tokens": jnp.asarray(toks[:, S:])},
                                   jnp.int32(S))
    return SimpleNamespace(
        name=request.param, jcfg=jcfg, tcfg=tcfg, tparams=tparams, toks=toks,
        logits=logits, cache=cache, dlogits=dlogits, dcache=dcache,
        generated=jeng.generate(toks[:, :S]))


def _port_prefill(lm, n=S, cache_len=S + NEW):
    model = Model(lm.tcfg, device="cpu")
    return model, model.prefill(lm.tparams,
                                {"tokens": torch.as_tensor(lm.toks[:, :n])},
                                cache_len=cache_len)


# ---------------------------------------------------------------- modules

def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    got = layers.rmsnorm({"scale": torch.as_tensor(scale)}, torch.as_tensor(x),
                         1e-6)
    _close(got, want, MODULE_TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = layers.rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    _close(got, want, MODULE_TOL)


@pytest.mark.parametrize("window", [None, 8])
def test_mea_matches_reference(window):
    """Causal and windowed; 37 positions in chunks of 16, so both the
    query and the key side are padded."""
    cfg = jconfigs.smoke_config(ARCH).with_overrides(**F32)
    tcfg = convert.model_config_from_reference(dataclasses.asdict(cfg))
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 37, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 37, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 37, 2, 16)).astype(np.float32)
    pos = np.arange(37, dtype=np.int32)
    want = jlayers._mea(*map(jnp.asarray, (q, k, v, pos, pos)), cfg, window)
    got = layers._mea(*map(torch.as_tensor, (q, k, v, pos, pos)), tcfg, window)
    _close(got, want, MODULE_TOL)


@pytest.mark.parametrize("arch", [ARCH, "granite_34b"])
def test_mlp_matches_reference(arch):
    """SwiGLU (Jamba) and the 2-matrix tanh-GELU MLP (Granite)."""
    cfg = jconfigs.smoke_config(arch).with_overrides(**F32)
    jparams, tcfg, tparams = _pair(cfg)
    x = np.random.default_rng(3).standard_normal((2, 9, 64)).astype(np.float32)
    want = jlayers.mlp(jparams["unit"][0]["ffn"] if arch == ARCH
                       else jax.tree.map(lambda a: a[0],
                                         jparams["unit"][0]["ffn"]),
                       jnp.asarray(x), cfg)
    tffn = tparams["unit"][0]["ffn"]
    if arch != ARCH:
        tffn = {k: v[0] for k, v in tffn.items()}
    got = layers.mlp(tffn, torch.as_tensor(x), tcfg)
    _close(got, want, MODULE_TOL)


@pytest.mark.parametrize("combine", ["gather", "scatter"])
@pytest.mark.parametrize("capacity", [0.0, 1.25, 0.5])
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_apply_matches_reference(smoke_params, combine, capacity, groups):
    """Both combine modes; dropless, the default capacity factor and a
    tight one that drops tokens; one and two groups."""
    jparams, _, tparams = smoke_params
    cfg = jconfigs.smoke_config(ARCH).with_overrides(
        moe_combine=combine, moe_capacity_factor=capacity, **F32)
    tcfg = convert.model_config_from_reference(dataclasses.asdict(cfg))
    x = np.random.default_rng(4).standard_normal((2, 24, 64)).astype(np.float32)
    want = jmoe.moe_apply(jparams["unit"][1]["ffn"], jnp.asarray(x), cfg, groups)
    got = moe.moe_apply(tparams["unit"][1]["ffn"], torch.as_tensor(x), tcfg,
                        groups)
    _close(got, want, MODULE_TOL)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("seq", [48, 256])
def test_mamba_train_matches_reference(smoke_params, fuse, seq):
    """Both reference branches (``_scan_chunked`` + projection, and
    ``_fused_scan``) against the port's one path through
    ``ops.selective_scan``, with the decode state; 256 steps run two of
    the reference's 128-step chunks."""
    jparams, _, tparams = smoke_params
    cfg = jconfigs.smoke_config(ARCH).with_overrides(mamba_fuse_proj=fuse,
                                                     **F32)
    tcfg = convert.model_config_from_reference(dataclasses.asdict(cfg))
    x = np.random.default_rng(5).standard_normal((2, seq, 64)).astype(np.float32)
    want, wstate = jssm.mamba_train(jparams["unit"][0]["mixer"], jnp.asarray(x),
                                    cfg, return_state=True)
    got, gstate = ssm.mamba_train(tparams["unit"][0]["mixer"],
                                  torch.as_tensor(x), tcfg, return_state=True)
    _close(got, want, MODULE_TOL, "out")
    _close(gstate["h"], wstate["h"], MODULE_TOL, "h")
    _close(gstate["conv"], wstate["conv"], MODULE_TOL, "conv")
    assert torch.equal(ssm.mamba_train(tparams["unit"][0]["mixer"],
                                       torch.as_tensor(x), tcfg), got)


# ---------------------------------------------------------------- the model

@pytest.mark.parametrize("cast_once", [False, True])
def test_forward_hidden_matches_reference(smoke_params, cast_once):
    """The full-sequence forward (``block_train`` in every layer, the
    scan without its state), with and without ``cast_params_once``."""
    jparams, _, tparams = smoke_params
    cfg = jconfigs.smoke_config(ARCH).with_overrides(
        cast_params_once=cast_once, **F32)
    tcfg = convert.model_config_from_reference(dataclasses.asdict(cfg))
    toks = _tokens(cfg.vocab_size, 4)[:, :S]
    want = jax.jit(lambda p, t: jtransformer.forward_hidden(
        p, {"tokens": t}, cfg))(jparams, jnp.asarray(toks))
    got = transformer.forward_hidden(tparams, {"tokens": torch.as_tensor(toks)},
                                     tcfg)
    _close(got, want, MODEL_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_cache_matches_reference(case):
    arch, over = CASES[case]
    jcfg = jconfigs.smoke_config(arch).with_overrides(**over)
    tcfg = convert.model_config_from_reference(dataclasses.asdict(jcfg))
    want = _flat(jtransformer.make_cache(jcfg, 3, 40))
    got = _flat(Model(tcfg, device="cpu").make_cache(3, 40))
    assert [(tuple(w.shape), np.dtype(w.dtype).name) for w in want] == \
        [(tuple(g.shape), str(g.dtype).split(".")[-1]) for g in got]
    assert all(not g.any() for g in got)


def test_prefill_matches_reference(lm):
    _, (logits, cache) = _port_prefill(lm)
    assert logits.dtype == torch.float32 and logits.shape == (B, lm.jcfg.vocab_size)
    _close(logits, lm.logits, MODEL_TOL, "logits")
    _trees_close(cache, lm.cache, MODEL_TOL)


def test_decode_step_matches_reference(lm):
    model, (_, cache) = _port_prefill(lm)
    logits, cache = model.decode_step(
        lm.tparams, cache, {"tokens": torch.as_tensor(lm.toks[:, S:])}, S)
    _close(logits, lm.dlogits, MODEL_TOL, "logits")
    _trees_close(cache, lm.dcache, MODEL_TOL)


def test_generate_greedy_matches_reference(lm):
    model = Model(lm.tcfg, device="cpu")
    eng = Engine(model, lm.tparams, ServeConfig(max_new_tokens=NEW))
    out = eng.generate(lm.toks[:, :S])
    assert out.dtype == lm.generated.dtype
    np.testing.assert_array_equal(out, lm.generated)


def _serving_bar(got, want):
    """``tests/test_serve.py``'s bar: 0.15 absolute and relative, argmax
    agreement >= 0.95."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0.15, atol=0.15)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= 0.95, f"argmax agreement {agree}"


def _teacher_forcing(tcfg, tparams, toks):
    """Logits of [prefill(S) -> decode token S] and of prefill(S + 1)."""
    model = Model(tcfg, device="cpu")
    _, cache = model.prefill(tparams, {"tokens": torch.as_tensor(toks[:, :S])},
                             cache_len=S + 8)
    logits_a, _ = model.decode_step(
        tparams, cache, {"tokens": torch.as_tensor(toks[:, S:S + 1])}, S)
    logits_b, _ = model.prefill(tparams, {"tokens": torch.as_tensor(toks)})
    return logits_a.float().numpy(), logits_b.float().numpy()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_matches_teacher_forcing(dtype):
    """``tests/test_serve.py``'s check for the port alone: the KV cache,
    the ring bookkeeping and the Mamba state carried by prefill."""
    over = F32 if dtype == "f32" else {}
    jcfg = jconfigs.smoke_config(ARCH).with_overrides(**over)
    _, tcfg, tparams = _pair(jcfg)
    logits_a, logits_b = _teacher_forcing(tcfg, tparams,
                                          _tokens(jcfg.vocab_size, 6))
    _serving_bar(logits_a, logits_b)


def _prefill_decode_both(jcfg, jparams, tcfg, tparams, prompt, step):
    """The reference's jitted prefill of ``prompt`` (S positions, 8 of
    headroom) and one decode step of ``step`` at position S, then the
    port's: ``(logits, cache, step logits, step cache)`` for each, the
    port's prefill cache copied before the step writes into it."""
    jmodel = JModel(jcfg)
    jl, jc = jax.jit(jmodel.prefill, static_argnames=("cache_len",))(
        jparams, jax.tree.map(jnp.asarray, prompt), cache_len=S + 8)
    jd, jdc = jax.jit(jmodel.decode_step)(
        jparams, jc, jax.tree.map(jnp.asarray, step), jnp.int32(S))
    model = Model(tcfg, device="cpu")
    tl, tc = model.prefill(tparams, {k: torch.as_tensor(v)
                                     for k, v in prompt.items()},
                           cache_len=S + 8)
    tc0 = tree_map(torch.clone, tc)
    td, tdc = model.decode_step(tparams, tc, {k: torch.as_tensor(v)
                                              for k, v in step.items()}, S)
    return (jl, jc, jd, jdc), (tl, tc0, td, tdc)


def test_bf16_matches_reference_at_serving_bar():
    """The default ``SMOKE`` (bf16 compute): prefill and a decode step
    against the reference at ``tests/test_serve.py``'s bar."""
    jcfg = jconfigs.smoke_config(ARCH)
    jparams, tcfg, tparams = _pair(jcfg)
    assert tcfg.compute_dtype == torch.bfloat16
    toks = _tokens(jcfg.vocab_size, 7)
    (jl, _, jd, _), (tl, tc, td, _) = _prefill_decode_both(
        jcfg, jparams, tcfg, tparams, {"tokens": toks[:, :S]},
        {"tokens": toks[:, S:]})
    assert tc["unit"][4]["k"].dtype == torch.bfloat16
    for got, want in ((tl, jl), (td, jd)):
        _serving_bar(got, want)


RWKV = "rwkv6_7b"
FRONTENDS = ["musicgen_medium", "internvl2_76b"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rwkv_decode_matches_teacher_forcing(dtype):
    """``tests/test_serve.py``'s check (b = 2, s = 48) for the port's
    RWKV alone: the state and the token shifts that prefill carries into
    decode.  In f32 also within MODEL_TOL."""
    over = F32 if dtype == "f32" else {}
    jcfg = jconfigs.smoke_config(RWKV).with_overrides(**over)
    _, tcfg, tparams = _pair(jcfg)
    logits_a, logits_b = _teacher_forcing(tcfg, tparams,
                                          _tokens(jcfg.vocab_size, 6))
    if dtype == "f32":
        _close(logits_a, logits_b, MODEL_TOL)
    _serving_bar(logits_a, logits_b)


def test_rwkv_bf16_matches_reference_at_serving_bar():
    """RWKV's default ``SMOKE`` (bf16 compute): prefill and a decode
    step against the reference; the state stays f32, the token shifts
    bf16."""
    jcfg = jconfigs.smoke_config(RWKV)
    jparams, tcfg, tparams = _pair(jcfg)
    assert tcfg.compute_dtype == torch.bfloat16
    toks = _tokens(jcfg.vocab_size, 7)
    (jl, jc, jd, _), (tl, tc, td, tdc) = _prefill_decode_both(
        jcfg, jparams, tcfg, tparams, {"tokens": toks[:, :S]},
        {"tokens": toks[:, S:]})
    unit = tc["unit"][0]
    assert unit["s"].dtype == torch.float32
    assert unit["tm_xprev"].dtype == unit["cm_xprev"].dtype == torch.bfloat16
    _trees_close(tree_map(lambda t: t.float(), tc), jc, 2.0 ** -7)
    for got, want in ((tl, jl), (td, jd)):
        _serving_bar(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_frontend_prefill_and_decode_from_embeds_match_reference(arch, dtype):
    """MusicGen's audio frames and InternVL2's vision patches through
    ``frontend.proj``: prefill of 48 positions and a decode step, each
    from ``embeds``; f32 within MODEL_TOL (logits and caches), bf16 at
    the serving bar."""
    over = F32 if dtype == "f32" else {}
    jcfg = jconfigs.smoke_config(arch).with_overrides(**over)
    jparams, tcfg, tparams = _pair(jcfg)
    fd = transformer.FRONTEND_DIMS[tcfg.frontend]
    assert fd == jtransformer.FRONTEND_DIMS[jcfg.frontend]
    emb = np.random.default_rng(8).standard_normal(
        (B, S + 1, fd)).astype(np.float32)
    (jl, jc, jd, jdc), (tl, tc, td, tdc) = _prefill_decode_both(
        jcfg, jparams, tcfg, tparams, {"embeds": emb[:, :S]},
        {"embeds": emb[:, S:]})
    if dtype == "f32":
        _close(tl, jl, MODEL_TOL, "prefill logits")
        _trees_close(tc, jc, MODEL_TOL)
        _close(td, jd, MODEL_TOL, "decode logits")
        _trees_close(tdc, jdc, MODEL_TOL)
    else:
        _serving_bar(tl, jl)
        _serving_bar(td, jd)


# ---------------------------------------------------------------- sampling

def test_gumbel_matches_reference():
    from repro_torch.serve.engine import gumbel
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.gumbel(key, (4, 256), jnp.float32))
    got = gumbel(keys.prng_key(11), (4, 256)).numpy()
    # the uniforms are equal bit for bit; -log(-log(u)) differs by the
    # last ulp of each log
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_temperature_sampling_matches_reference():
    """The engine's sampler on fixed logits over its key schedule
    (``PRNGKey(seed)`` for the first token, then one ``split`` per
    step): the same tokens as the reference engine's."""
    jcfg = jconfigs.smoke_config(ARCH)
    sc = dict(max_new_tokens=6, temperature=0.7, seed=3)
    jeng = JEngine(JModel(jcfg), None, JServeConfig(**sc))
    teng = Engine(Model(configs.smoke_config(ARCH), device="cpu"), None,
                  ServeConfig(**sc))
    rng = np.random.default_rng(12)
    jkey, tkey = jax.random.PRNGKey(3), keys.prng_key(3)
    for step in range(6):
        logits = (3.0 * rng.standard_normal((4, 256))).astype(np.float32)
        if step:
            jkey, jsub = jax.random.split(jkey)
            tkey, tsub = keys.split(tkey).unbind(0)
        else:
            jsub, tsub = jkey, tkey
        want = np.asarray(jeng._sample(jnp.asarray(logits), jsub))
        got = teng._sample(torch.as_tensor(logits), tsub).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- structure

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
@pytest.mark.parametrize("which", ["CONFIG", "SMOKE"])
def test_config_registry_matches_reference(arch, which):
    get = (lambda m, a: m.get_config(a)) if which == "CONFIG" else \
        (lambda m, a: m.smoke_config(a))
    want = convert.model_config_from_reference(
        dataclasses.asdict(get(jconfigs, arch)))
    assert get(configs, arch) == want


SUPPORTED = jconfigs.ARCH_IDS


@pytest.mark.parametrize("arch", SUPPORTED)
def test_decls_match_reference(arch):
    """Same tree, shapes, init rules and fan-ins as the reference's
    declarations, at full width and at the serving overrides (bf16
    weights); so conversion is leaf for leaf."""
    for over in ({}, dict(param_dtype="bf16")):
        jcfg = jconfigs.get_config(arch).with_overrides(**over)
        tcfg = convert.model_config_from_reference(dataclasses.asdict(jcfg))
        want = jax.tree.leaves(jtransformer.model_decls(jcfg),
                               is_leaf=lambda x: hasattr(x, "spec"))
        got = _flat(transformer.model_decls(tcfg))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g.shape, g.init, g.fan_in) == (tuple(w.shape), w.init,
                                                   w.fan_in)
            assert str(g.dtype).split(".")[-1] == np.dtype(w.dtype).name
        assert Model(tcfg, device="cpu").num_params() == \
            JModel(jcfg).num_params()


def test_layer_plan_matches_reference():
    for arch in jconfigs.ARCH_IDS:
        for cfg in (jconfigs.get_config(arch), jconfigs.smoke_config(arch)):
            assert transformer.layer_plan(cfg.layer_pattern) == \
                jtransformer.layer_plan(cfg.layer_pattern)


def test_full_width_jamba_served_at_eight_layers_fits_the_card():
    """The configuration the card serves: 8 of Jamba's 32 layers, bf16
    weights, dropless MoE: 13.30 B parameters, 26.6 GB."""
    cfg = configs.get_config(ARCH).with_overrides(
        num_layers=8, layer_pattern="mMmMaMmM", param_dtype="bf16",
        moe_capacity_factor=0.0)
    n = Model(cfg, device="cpu").num_params()
    assert 13.25e9 < n < 13.35e9
    assert 51.5e9 < Model(configs.get_config(ARCH), device="cpu").num_params() \
        < 51.6e9


# name -> (overrides of the full config, parameters): the configurations
# the card serves (RWKV6-7B and MusicGen-medium whole, InternVL2-76B at
# 4 of its 80 layers in bf16)
SERVED = {"rwkv6_7b": ({}, 7_534_546_944),
          "musicgen_medium": ({}, 1_818_576_384),
          "internvl2_76b": (dict(num_layers=4, layer_pattern="T" * 4,
                                 param_dtype="bf16"), 5_550_186_496)}


@pytest.mark.parametrize("arch", sorted(SERVED))
def test_full_width_parameter_counts_of_the_served_configurations(arch):
    over, count = SERVED[arch]
    jcfg = jconfigs.get_config(arch).with_overrides(**over)
    tcfg = convert.model_config_from_reference(dataclasses.asdict(jcfg))
    assert Model(tcfg, device="cpu").num_params() == \
        JModel(jcfg).num_params() == count


def test_model_takes_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(configs.smoke_config(ARCH))


def _launch_serve(arch):
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                           "--batch", "2", "--prompt-len", "8",
                           "--max-new", "4"])
    assert "generated 8 tokens" in buf.getvalue()
    assert "on cpu" in buf.getvalue()


def test_launch_serve_runs_on_cpu():
    _launch_serve(ARCH)


def test_launch_serve_rwkv_runs_on_cpu():
    """An 8-token prompt: one chunk of 8 through the RWKV prefill."""
    _launch_serve(RWKV)
