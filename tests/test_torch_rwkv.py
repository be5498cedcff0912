"""The port's RWKV-6 block against the JAX package's, on the CPU.

``repro_torch.models.rwkv`` against ``repro.models.rwkv`` module by
module: the time-mix inputs (the five token-shift mixes, the
data-dependent decay), the exact WKV recurrence, the per-head group
norm, the time-mix and the channel-mix.  Weights are drawn by the
reference at RWKV6-7B's ``SMOKE`` width and carried over by
``convert.lm_params_from_reference``; the parameters that start at zero
or one (the mixes, the decay base, the bonus, the norm's scale) are
redrawn from ``numpy.random.default_rng`` so that every term counts, the
decay base across [-12, 8] so that both clip ends (-8 and 4) are
reached; the state and the token shifts are nonzero.

Sequences of 1, 16, 64 and 128 tokens (128 is two of the reference's
64-token chunks).  In f32 both sides run the same arithmetic in the same
order and differ in the order of the sums inside products and in the
last ulp of ``exp``/``tanh``: within ``1e-5`` of the reference's largest
magnitude.  In bf16 the port rounds where the reference's jitted code
rounds on the CPU, so almost every value is the same bits.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import configs as jconfigs
from repro.models import rwkv as jrwkv
from repro.models.api import Model as JModel

from repro_torch import convert
from repro_torch.models import rwkv

ARCH = "rwkv6_7b"
TOL = 1e-5
SEQS = [1, 16, 64, 128]
REDRAWN = {"mu_r": (-1, 1), "mu_k": (-1, 1), "mu_v": (-1, 1),
           "mu_w": (-1, 1), "mu_g": (-1, 1), "cmu_k": (-1, 1),
           "cmu_r": (-1, 1), "bonus_u": (-1, 1), "ln_scale": (0.5, 1.5),
           "decay_base": (-12, 8)}


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


def _setup(dtype):
    """(reference config, port config, reference tm params, port tm
    params) of layer 0, compute in ``dtype``."""
    over = dict(compute_dtype=jnp.float32) if dtype == "f32" else {}
    jcfg = jconfigs.smoke_config(ARCH).with_overrides(**over)
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    tcfg = convert.model_config_from_reference(dataclasses.asdict(jcfg))
    jtm = {k: np.asarray(v[0], np.float32)
           for k, v in jparams["unit"][0]["tm"].items()}
    rng = np.random.default_rng(0)
    for name, (lo, hi) in REDRAWN.items():
        jtm[name] = rng.uniform(lo, hi, jtm[name].shape).astype(np.float32)
    ttm = convert.lm_params_from_reference(jtm)
    return jcfg, tcfg, {k: jnp.asarray(v) for k, v in jtm.items()}, ttm


@pytest.fixture(scope="module", params=["f32", "bf16"])
def setup(request):
    return (request.param,) + _setup(request.param)


def _inputs(s, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    x_prev = rng.standard_normal((2, 1, d)).astype(np.float32)
    return x, x_prev


def _both(a, jdt, tdt):
    return jnp.asarray(a).astype(jdt), torch.as_tensor(a).to(tdt)


def _state(cfg, seed):
    h, hd = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    return np.random.default_rng(seed).standard_normal(
        (2, h, hd, hd)).astype(np.float32)


def _module_close(dtype, got, want, what):
    """f32 compute: within TOL.  bf16 compute (a value rounded to bf16
    somewhere on its way): within one bf16 step of the largest
    magnitude, and at least 99% of the values the same bits."""
    if dtype == "f32":
        _close(got, want, TOL, what)
        return
    _close(got, want, 2.0 ** -8, what)
    same = float((_np(got) == _np(want)).mean())
    assert same >= 0.99, f"{what}: {same} of the values equal"


@pytest.mark.parametrize("s", SEQS)
def test_time_mix_inputs_match_reference(setup, s):
    dtype, jcfg, tcfg, jtm, ttm = setup
    x, xs = _inputs(s, jcfg.d_model, 1)
    xs = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    jx, tx = _both(x, jcfg.compute_dtype, tcfg.compute_dtype)
    jxs, txs = _both(xs, jcfg.compute_dtype, tcfg.compute_dtype)
    want = jax.jit(lambda p, a, b: jrwkv._time_mix_inputs(p, a, b, jcfg))(
        jtm, jx, jxs)
    got = rwkv._time_mix_inputs(ttm, tx, txs, tcfg)
    for name, g, w in zip("rkvgwu", got, want):
        assert str(g.dtype).split(".")[-1] == np.dtype(w.dtype).name, name
        # w and u are f32 arithmetic of f32 values in both computes
        _module_close("f32" if name in "wu" else dtype, g, w, name)
    w = _np(got[4])
    assert w.min() < 1e-20 and w.max() > 0.9996, "both clip ends reached"


@pytest.mark.parametrize("s", SEQS)
def test_wkv_scan_matches_reference(s):
    """Random r, k, v, u, a nonzero start state, and decays spread over
    the clip range: w = exp(-exp(dec)) for dec in [-8, 4]."""
    rng = np.random.default_rng(3)
    b, h, hd = 2, 4, 16
    r, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    dec = rng.uniform(-8, 4, (b, s, h, hd)).astype(np.float32)
    dec.flat[:2] = (-8.0, 4.0)
    w = np.exp(-np.exp(dec)).astype(np.float32)
    u = rng.standard_normal((h, hd)).astype(np.float32)
    s0 = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    args = (r, k, v, w, u, s0)
    wy, ws = jax.jit(jrwkv._wkv_scan)(*map(jnp.asarray, args))
    gy, gs = rwkv._wkv_scan(*map(torch.as_tensor, args))
    _close(gy, wy, TOL, "y")
    _close(gs, ws, TOL, "state")


def test_wkv_scan_raises_where_the_reference_does():
    """100 tokens are not a whole number of 64-token chunks: the
    reference asserts, the port raises naming the chunk; neither pads."""
    args = [np.zeros((1, 100, 2, 4), np.float32)] * 4 + \
        [np.zeros((2, 4), np.float32), np.zeros((1, 2, 4, 4), np.float32)]
    with pytest.raises(AssertionError):
        jrwkv._wkv_scan(*map(jnp.asarray, args))
    with pytest.raises(ValueError, match="chunk 64"):
        rwkv._wkv_scan(*map(torch.as_tensor, args))


@pytest.mark.parametrize("s", SEQS)
def test_group_norm_matches_reference(s):
    """Per-head normalisation by the population variance (``jnp.var``)."""
    rng = np.random.default_rng(4)
    y = (rng.standard_normal((2, s, 64)) * 3 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    want = jrwkv._group_norm(jnp.asarray(y), jnp.asarray(scale), 4, 1e-6)
    got = rwkv._group_norm(torch.as_tensor(y), torch.as_tensor(scale), 4,
                           1e-6)
    _close(got, want, TOL)


@pytest.mark.parametrize("s", SEQS)
def test_time_mix_matches_reference(setup, s):
    dtype, jcfg, tcfg, jtm, ttm = setup
    x, x_prev = _inputs(s, jcfg.d_model, 5)
    s0 = _state(jcfg, 6)
    jx, tx = _both(x, jcfg.compute_dtype, tcfg.compute_dtype)
    jxp, txp = _both(x_prev, jcfg.compute_dtype, tcfg.compute_dtype)
    wy, wxp, ws = jax.jit(lambda p, a, b, c: jrwkv.rwkv_time_mix(
        p, a, jcfg, b, c))(jtm, jx, jxp, jnp.asarray(s0))
    gy, gxp, gs = rwkv.rwkv_time_mix(ttm, tx, tcfg, txp, torch.as_tensor(s0))
    assert gy.dtype == tcfg.compute_dtype and gs.dtype == torch.float32
    _module_close(dtype, gy, wy, "y")
    _close(gs, ws, TOL, "state")      # f32 in both computes
    assert torch.equal(gxp, tx[:, -1:])
    np.testing.assert_array_equal(_np(gxp), _np(wxp))


@pytest.mark.parametrize("s", SEQS)
def test_channel_mix_matches_reference(setup, s):
    dtype, jcfg, tcfg, jtm, ttm = setup
    x, x_prev = _inputs(s, jcfg.d_model, 7)
    jx, tx = _both(x, jcfg.compute_dtype, tcfg.compute_dtype)
    jxp, txp = _both(x_prev, jcfg.compute_dtype, tcfg.compute_dtype)
    wy, wxp = jax.jit(lambda p, a, b: jrwkv.rwkv_channel_mix(
        p, a, jcfg, b))(jtm, jx, jxp)
    gy, gxp = rwkv.rwkv_channel_mix(ttm, tx, tcfg, txp)
    assert gy.dtype == tcfg.compute_dtype
    _module_close(dtype, gy, wy, "y")
    np.testing.assert_array_equal(_np(gxp), _np(wxp))


def test_time_mix_raises_on_a_ragged_prompt():
    """A 100-token prompt fails in both packages."""
    jcfg, tcfg, jtm, ttm = _setup("f32")
    x, x_prev = _inputs(100, jcfg.d_model, 8)
    s0 = _state(jcfg, 9)
    with pytest.raises(AssertionError):
        jrwkv.rwkv_time_mix(jtm, jnp.asarray(x), jcfg, jnp.asarray(x_prev),
                            jnp.asarray(s0))
    with pytest.raises(ValueError, match="chunk"):
        rwkv.rwkv_time_mix(ttm, torch.as_tensor(x), tcfg,
                           torch.as_tensor(x_prev), torch.as_tensor(s0))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_make_cache_matches_reference(dtype):
    over = dict(compute_dtype=jnp.float32) if dtype == "f32" else {}
    jcfg = jconfigs.smoke_config(ARCH).with_overrides(**over)
    tcfg = convert.model_config_from_reference(dataclasses.asdict(jcfg))
    want = jrwkv.rwkv_make_cache(jcfg, 3)
    got = rwkv.rwkv_make_cache(tcfg, 3, "cpu")
    assert sorted(got) == sorted(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
        assert str(got[name].dtype).split(".")[-1] == \
            np.dtype(want[name].dtype).name, name
        assert not got[name].any()
    assert got["s"].dtype == torch.float32


def test_decls_match_reference():
    """Keys, shapes, init rules and fan-ins (``decay_b``'s is the rank)."""
    for arch_cfg in (jconfigs.smoke_config(ARCH), jconfigs.get_config(ARCH)):
        tcfg = convert.model_config_from_reference(
            dataclasses.asdict(arch_cfg))
        want = jrwkv.rwkv_decls(arch_cfg)
        got = rwkv.rwkv_decls(tcfg)
        assert list(got) == list(want)
        for name, w in want.items():
            g = got[name]
            assert (g.shape, g.init, g.fan_in) == (tuple(w.shape), w.init,
                                                   w.fan_in), name
    assert rwkv.rwkv_decls(tcfg)["decay_b"].fan_in == rwkv.DECAY_RANK == 64
    assert rwkv.CHUNK == jrwkv.CHUNK
