"""Parity of the port's large-T covariance path with the JAX package, on
the CPU: ``ops.chol_block``, ``ops.blocked`` (the fused-gram blocked
factorization), the large-T routes of ``ops.tri_inv``, ``ops.chol`` and
``ops.logdet``, ``gp.chol_gram_bank`` above T=64, the ``bench_t100``
ELBO, its preset and the CLI's ``--time-len``.

Each port function runs its plain route here (the CUDA kernels are held
against the same plain versions on the card, ``tests/test_torch_cuda.py``)
on numpy inputs from a seed.  Two kinds of reference:
* the JAX package's float64 routes (``jnp.linalg.cholesky``, its XLA
  helpers), against the port in float64, to 1e-9 relative;
* its Pallas kernel routes in interpret mode, which compute in float32:
  the port's float64 result is the oracle, and the JAX result is held to
  it with the bands of the JAX package's own tests (named at each use).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpvae_tpu import configs as jconfigs
from gpvae_tpu import gp as jgp
from gpvae_tpu import kernels as jkernels
from gpvae_tpu.models import GPVAE as JGPVAE
from gpvae_tpu.ops import chol as jchol
from gpvae_tpu.ops import logdet as jlogdet
from gpvae_tpu.ops import pallas_big, pallas_chol, pallas_tri
from gpvae_tpu_torch import configs, convert, gp, kernels
from gpvae_tpu_torch.models import GPVAE, GPVAEConfig
from gpvae_tpu_torch.ops import blocked, chol, chol_block, logdet, tri_inv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# matrices per JAX call: one shape, so the Pallas kernels that interpret
# mode traces are compiled once for the whole file (and 8 is what the
# fused-gram TPU kernels require, pallas_big._slab8)
N = 8
FP64_REL = 1e-9
# a float32 Cholesky of the JAX kernel route against the float64 oracle,
# max abs error over the largest entry: the band of tests/test_ops.py
# (gram_chol_inv_128_parts, the in-place flows), or 4x the error of the
# library's own float32 factor (LAPACK) of the same K, whichever is larger
# (the float32 error grows with cond(K); chip_smoke.py's rule)
FACTOR_FP32_REL = 2e-4
INV_FP32_REL = 5e-4
VS_LIBRARY = 4.0
# the whole ELBO: float64 against the JAX model as test_torch_model.py
# holds syn_data (its sampler pins float32: gpvae_tpu/gp.py:546-553);
# float32 gradients against the JAX model, the lengthscale gradient
# through the Cholesky reverse mode of a K with cond ~1e4 looser
ELBO_FP64_REL = 1e-7
GRAD_FP32_REL = 2e-4
LOG_LS_GRAD_FP32_REL = 2e-3


# The JAX reference of a single call whose Pallas kernels no other test
# compiles at the same shape (tri_inv's flat route at T=1024) goes through
# one jit with XLA's LLVM optimizations off: its interpret-mode compile
# takes about a third less time, and it computes the same operations.
# (Elsewhere the package's eager calls share compiled kernels across tests,
# which one jit around the call would lose.)
_ONCE_OPTIONS = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def _jax_once(fn, *args):
    return jax.jit(fn, compiler_options=_ONCE_OPTIONS)(*args)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / np.abs(ref).max()


def _flat(seed, n, t, *, hide=0.2, span=60.0, ls=(2.0, 9.0)):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, span, (n, t)), axis=-1)
    mask = rng.random((n, t)) > hide
    mask[:, 0] = True
    return (times, mask, rng.uniform(*ls, n), rng.uniform(0.5, 1.5, n))


def _gram64(times, mask, ls, var, noise=1e-3):
    k = np.asarray(jkernels.gram(
        jnp.asarray(times), jnp.asarray(ls)[:, None, None], noise=noise,
        variance=jnp.asarray(var)[:, None, None], mask=jnp.asarray(mask)))
    # a float64 oracle or none: JAX without x64 would round the times and
    # the gram to float32 and weaken every comparison made against it
    assert k.dtype == np.float64, (
        f"JAX built the gram in {k.dtype}: jax_enable_x64 is off in this "
        f"process (tests/conftest.py turns it on)")
    return k


def _gram64_np(times, mask, ls, var, noise):
    """The masked RBF gram bank in float64 by numpy alone (the JAX gram's
    semantics), for a float64 oracle that no JAX state reaches."""
    dt = (times[:, :, None] - times[:, None, :]) / ls[:, None, None]
    k = (1.0 - noise) * var[:, None, None] * np.exp(-0.5 * dt * dt)
    eye = np.eye(times.shape[1])
    m = mask.astype(np.float64)
    k = (k + noise * eye) * (m[:, :, None] * m[:, None, :])
    return k + (1.0 - m[:, :, None]) * eye


def _t(x, dtype=torch.float64):
    return torch.tensor(np.asarray(x), dtype=dtype)


# The JAX glue kernels join 64-wide halves through explicit float32
# inverses, which break down (inf, NaN, or entries of 1e27) on 128-wide
# grams of cond(K) ~ 1e3-1e4 when few rows are masked (seed 21 with hide
# 0.2 or 0.0, on the CPU); their tests below use half the rows masked.


def _fp32_bands(k):
    """``(factor band, inverse band)`` for a float32 route on the SPD bank
    ``k``: the fixed bands above or 4x the library's float32 errors."""
    want = np.linalg.cholesky(k)
    l32 = torch.linalg.cholesky(_t(k, torch.float32))
    x32 = tri_inv.tri_inv_plain(l32)
    return (max(FACTOR_FP32_REL, VS_LIBRARY * _rel(l32.numpy(), want)),
            max(INV_FP32_REL, VS_LIBRARY * _rel(x32.numpy(),
                                                np.linalg.inv(want))))


# ---------------------------------------------------------------------------
# chol_block: the diagonal-block kernel's plain route
# ---------------------------------------------------------------------------

def _assemble(a11, a21, a22):
    a11, a21, a22 = (np.asarray(a) for a in (a11, a21, a22))
    return np.block([[a11, np.zeros_like(a11)], [a21, a22]])


@pytest.mark.parametrize("jax_fn", ["chol_128", "chol_inv_128_parts"])
def test_chol_block_matches_jax_128_glue(jax_fn):
    """A 128-wide pre-built block: the port's single block against the TPU
    package's 64-wide halves joined by its glue kernels (interpret)."""
    times, mask, ls, var = _flat(21, N, 128, span=30.0, ls=(1.0, 3.0),
                           hide=0.5)
    k = _gram64(times, mask, ls, var, noise=1e-2)
    l, x = chol_block.chol_block(_t(k), inverse=True)
    want = np.linalg.cholesky(k)
    assert _rel(l.numpy(), want) <= FP64_REL
    assert _rel(x.numpy(), np.linalg.inv(want)) <= FP64_REL
    assert torch.all(torch.triu(l, 1) == 0)
    l_band, x_band = _fp32_bands(k)
    got = getattr(pallas_chol, jax_fn)(jnp.asarray(k, jnp.float32))
    if jax_fn == "chol_128":
        assert _rel(got, l.numpy()) <= l_band
    else:
        l11, a21, l22, i11, i21, i22 = got
        assert _rel(_assemble(l11, a21, l22), l.numpy()) <= l_band
        assert _rel(_assemble(i11, i21, i22), x.numpy()) <= x_band


def test_gram_chol_block_matches_jax_gram_chol_inv_128_parts():
    """The block built from the time vectors, against the TPU package's
    fully fused first block: the gram lane kernel on the first 64-quadrant
    (``gram_chol_inv_small``), the gram Schur kernel and the lane kernels
    on the second."""
    times, mask, ls, var = _flat(31, N, 128, span=30.0, ls=(1.0, 3.0),
                           hide=0.5)
    l, x = chol_block.gram_chol_block(_t(times), _t(mask), _t(ls), _t(var),
                                      noise=1e-2, inverse=True)
    # the float64 oracle from numpy alone, so that no JAX state a worker
    # carries from an earlier test file reaches it
    k = _gram64_np(times, mask, ls, var, noise=1e-2)
    want = np.linalg.cholesky(k)
    assert _rel(l.numpy(), want) <= FP64_REL
    assert _rel(x.numpy(), np.linalg.inv(want)) <= FP64_REL
    l_band, x_band = _fp32_bands(k)
    f32 = [jnp.asarray(a, jnp.float32) for a in (times, mask, ls, var)]
    lsb, varb = (jnp.broadcast_to(a[:, None], (N, 128))
                 for a in (f32[2], f32[3]))
    l11, a21, l22, i11, i21, i22 = pallas_big.gram_chol_inv_128_parts(
        f32[0], f32[1], lsb, varb, "rbf", 1e-2)
    assert _rel(_assemble(l11, a21, l22), want) <= l_band
    assert _rel(_assemble(i11, i21, i22), x.numpy()) <= x_band


@pytest.mark.parametrize("mode", ["prebuilt", "gram"])
def test_chol_block_writes_in_place_at_a_row_stride(mode):
    """The blocked driver's calls: ``L`` written into a view inside a
    larger factor (the pre-built block read from that same view), and
    nothing written outside it."""
    times, mask, ls, var = _flat(22, 2, 100, span=30.0, ls=(1.0, 3.0))
    k = _gram64(times, mask, ls, var, noise=1e-2)
    big = torch.full((2, 160, 170), float("nan"), dtype=torch.float64)
    d = big[:, 30:130, 50:150]
    if mode == "prebuilt":
        d.copy_(_t(k))
        l, x = chol_block.chol_block(d, out=d)
    else:
        l, x = chol_block.gram_chol_block(_t(times), _t(mask), _t(ls),
                                          _t(var), noise=1e-2, out=d)
    assert l is d and x is None
    assert _rel(d.numpy(), np.linalg.cholesky(k)) <= FP64_REL
    assert torch.all(torch.triu(d, 1) == 0)
    outside = big.clone()
    outside[:, 30:130, 50:150] = float("nan")
    assert torch.isnan(outside).all()


# ---------------------------------------------------------------------------
# the blocked fused-gram factorization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", sorted(kernels.KERNELS))
def test_gram_tile_matches_jax(kernel):
    times, mask, ls, var = _flat(3, 2, 256)
    fm = mask.astype(np.float64)
    kfn = jkernels.get_kernel(kernel)
    for rows, cols in ((slice(128, 256), slice(128, 256)),
                       (slice(128, 256), slice(0, 128))):
        want = pallas_big._gram_tile(
            jnp.asarray(times[:, rows]), jnp.asarray(times[:, cols]),
            jnp.asarray(fm[:, rows]), jnp.asarray(fm[:, cols]),
            jnp.asarray(ls)[:, None], jnp.asarray(var)[:, None], 1e-3, kfn,
            rows == cols)
        got = blocked.gram_tile(_t(times), _t(fm), _t(ls), _t(var), rows,
                                cols, kernel=kernel)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("t", [100, 256, 384])
def test_blocked_factorization_matches_jax(t):
    """T=100: one ragged block; 256: block 0 and a final block; 384: also
    a middle block (history, panel, solve).  Noise 1e-2: at 1e-3 these
    grids reach cond(K) ~ 1e5-1e6, where the JAX route's float32
    factorization breaks down (NaN pivots on the CPU)."""
    times, mask, ls, var = _flat(50 + t, N, t)
    l = blocked.cholesky_gram_inplace(_t(times), _t(ls), _t(mask, torch.bool),
                                      _t(var), noise=1e-2)
    k = _gram64(times, mask, ls, var, noise=1e-2)
    want = np.linalg.cholesky(k)
    l_band, _ = _fp32_bands(k)
    assert _rel(l.numpy(), want) <= FP64_REL
    assert torch.all(torch.triu(l, 1) == 0)
    f32 = [jnp.asarray(a, jnp.float32) for a in (times, ls, var)]
    jl = pallas_big.cholesky_gram_inplace(f32[0], f32[1], jnp.asarray(mask),
                                          f32[2], noise=1e-2)
    assert _rel(jl, want) <= l_band
    # the port's own float32 plain route, same band
    l32 = blocked.cholesky_gram_inplace(
        _t(times, torch.float32), _t(ls, torch.float32),
        _t(mask, torch.bool), _t(var, torch.float32), noise=1e-2)
    assert _rel(l32.numpy(), want) <= l_band


def test_blocked_factorization_writes_every_element():
    """``L`` comes from ``torch.empty``: a NaN-filled allocation shows
    that each element is written, with a narrow last block (300 = 2 x 128
    + 44)."""
    times, mask, ls, var = _flat(8, 2, 300)
    real_empty = torch.empty

    def nan_empty(*args, **kwargs):
        return real_empty(*args, **kwargs).fill_(float("nan"))

    torch.empty = nan_empty
    try:
        l = blocked.cholesky_gram_inplace(_t(times), _t(ls),
                                          _t(mask, torch.bool), _t(var))
    finally:
        torch.empty = real_empty
    assert not torch.isnan(l).any()
    want = np.linalg.cholesky(_gram64(times, mask, ls, var))
    assert _rel(l.numpy(), want) <= FP64_REL


# ---------------------------------------------------------------------------
# tri_inv, the blocked backward and the logdet route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [100, 192, 320, 1024])
def test_tri_inv_large_t_matches_jax(t):
    """The flat (T=1024) and blocked (100, 192, 320: padding would cost
    more than 2x) routes against JAX's ``tri_inv`` (Pallas lane kernel in
    interpret, float32) and the float64 inverse."""
    times, mask, ls, var = _flat(60 + t, N if t < 1024 else 2, t, hide=0.1)
    l = np.linalg.cholesky(_gram64(times, mask, ls, var, noise=1e-2))
    assert (tri_inv._flat_pad_overhead(t) <= 2.0) == (
        pallas_tri._flat_pad_overhead(t) <= 2.0)
    x = tri_inv.tri_inv(_t(l))
    want = np.linalg.inv(l)
    assert _rel(x.numpy(), want) <= FP64_REL
    assert torch.all(torch.triu(x, 1) == 0)
    l32 = jnp.asarray(l, jnp.float32)
    # the blocked route's base shapes recur across T; the flat one's not
    jx = (_jax_once(pallas_tri.tri_inv, l32) if t == 1024
          else pallas_tri.tri_inv(l32))
    # the JAX package's own band (tests/test_ops.py:269)
    assert _rel(jx, want) <= 1e-4
    other = (tri_inv.tri_inv_blocked if tri_inv._flat_pad_overhead(t) <= 2.0
             else tri_inv.tri_inv_flat)  # the route not taken agrees too
    assert _rel(other(_t(l[:2])).numpy(), want[:2]) <= FP64_REL


def _cholesky_vjp_fp64(l, l_bar):
    """JAX's own derivative of ``jnp.linalg.cholesky`` at ``K = L L^T``
    (the package's ``cholesky_bwd_from_l`` pins float32,
    gpvae_tpu/ops/chol.py:603)."""
    k = jnp.einsum("...ij,...kj->...ik", jnp.asarray(l), jnp.asarray(l))
    _, vjp = jax.vjp(jnp.linalg.cholesky, k)
    return np.asarray(vjp(jnp.asarray(l_bar))[0])


def test_blocked_cholesky_backward_matches_jax_t256():
    times, mask, ls, var = _flat(70, 2, 256)
    l = np.linalg.cholesky(_gram64(times, mask, ls, var, noise=1e-2))
    l_bar = np.tril(np.random.default_rng(1).standard_normal(l.shape))
    got = chol.cholesky_bwd_from_l(_t(l), _t(l_bar)).numpy()
    assert _rel(got, _cholesky_vjp_fp64(l, l_bar)) <= FP64_REL
    # the blocks against JAX's (whose products are float32: 1e-6)
    w_blocks = chol._phi_w_blocks(_t(l), _t(l_bar))
    jw = jchol._phi_w_blocks(jnp.asarray(l), jnp.asarray(l_bar))
    for a, b in zip(w_blocks, jw):
        assert _rel(a.numpy(), b) <= 1e-6
    x = np.linalg.inv(l)
    w = np.random.default_rng(2).standard_normal(l.shape)
    w = w + np.swapaxes(w, -1, -2)
    h = 128
    np.testing.assert_allclose(
        chol._tri_sandwich_blocks(_t(x), _t(w[:, :h, :h]),
                                  _t(w[:, h:, :h]), _t(w[:, h:, h:])).numpy(),
        np.swapaxes(x, -1, -2) @ w @ x, rtol=1e-9, atol=1e-9)


def test_logdet_route_matches_jax_t256():
    """T=256 takes the diagonal kernel's route (an autograd Function on a
    strided [B, Z, T, T] view, gradient ``2 g / L_ii``)."""
    times, mask, ls, var = _flat(80, 6, 256)
    l = np.linalg.cholesky(_gram64(times, mask, ls, var)).reshape(
        3, 2, 256, 256)
    lt = _t(l).requires_grad_(True)
    half = lt[:, 1:]
    got = logdet.logdet_from_chol(half)
    assert got.grad_fn.name() == "_DiagLogdetBackward"
    want = jlogdet.logdet_from_chol(jnp.asarray(l[:, 1:]))
    assert _rel(got.detach().numpy(), want) <= FP64_REL
    g = np.random.default_rng(3).standard_normal((3, 1))
    got.backward(_t(g))
    _, vjp = jax.vjp(jlogdet.logdet_from_chol, jnp.asarray(l))
    assert _rel(lt.grad.numpy(), vjp(jnp.asarray(
        np.concatenate([np.zeros_like(g), g], 1)))[0]) <= FP64_REL
    # below the route's threshold the plain diagonal, as in JAX
    assert logdet.logdet_from_chol(_t(l[..., :100, :100])).grad_fn is None


# ---------------------------------------------------------------------------
# chol_gram_bank, the ELBO, the preset and the CLI
# ---------------------------------------------------------------------------

def _bank_loss(times, mask, ls, var, w, *, jax_impl=None):
    """``L`` and the gradients of ``sum(L * w)`` in lengthscales and
    variance: through JAX (``"fp64"``: autodiff of
    ``jnp.linalg.cholesky(gram_bank)``) or through the port."""
    if jax_impl is not None:
        def f(ls_, var_):
            if jax_impl == "fp64":
                l = jnp.linalg.cholesky(jkernels.gram_bank(
                    jnp.asarray(times), ls_, mask=jnp.asarray(mask),
                    variance=var_))
            else:
                l = jgp.chol_gram_bank(jnp.asarray(times), ls_,
                                       mask=jnp.asarray(mask), variance=var_,
                                       impl=jax_impl)
            return jnp.sum(l * jnp.asarray(w)), l
        (_, l), grads = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
            jnp.asarray(ls), jnp.asarray(var))
        return np.asarray(l), [np.asarray(g) for g in grads]
    dtype = torch.float64 if times.dtype == np.float64 else torch.float32
    lt = _t(ls, dtype).requires_grad_(True)
    vt = _t(var, dtype).requires_grad_(True)
    l = gp.chol_gram_bank(_t(times, dtype), lt, mask=_t(mask, torch.bool),
                          variance=vt)
    torch.sum(l * _t(w, dtype)).backward()
    return l.detach().numpy(), [lt.grad.numpy(), vt.grad.numpy()]


@pytest.mark.parametrize("t", [100, 256])
def test_chol_gram_bank_large_t_matches_jax_fp64(t):
    rng = np.random.default_rng(t)
    times = np.sort(rng.uniform(0.0, 60.0, (2, t)), axis=-1)
    mask = rng.random((2, t)) > 0.3
    ls, var = np.array([2.0, 5.0, 9.0, 3.0]), np.array([1.0, 0.7, 1.3, 0.9])
    w = rng.standard_normal((2, 4, t, t))
    ref_l, ref_g = _bank_loss(times, mask, ls, var, w, jax_impl="fp64")
    got_l, got_g = _bank_loss(times, mask, ls, var, w)
    assert _rel(got_l, ref_l) <= FP64_REL
    for g, r in zip(got_g, ref_g):
        assert g.shape == r.shape
        assert _rel(g, r) <= FP64_REL


def _batch(seed, b, t, d=15):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 60.0, (b, t)), axis=-1)
    mask = rng.random((b, t)) > 0.4
    mask[:, 0] = True
    x = (rng.random((b, t, d)) < 0.4) * mask[..., None]
    return x.astype(np.float64), times, mask


def _jax_model(cfg, x, times, mask, dtype):
    model = JGPVAE(cfg)
    params = jax.jit(model.init)(
        {"params": jax.random.key(0), "sample": jax.random.key(1)},
        jnp.asarray(x, dtype), jnp.asarray(times, dtype), jnp.asarray(mask))
    return model, jax.tree_util.tree_map(lambda a: a.astype(dtype), params)


def _jax_eps(model, params, key, shape, dtype):
    sample_key = model.apply(params, method=lambda m: m.make_rng("sample"),
                             rngs={"sample": key})
    return np.asarray(jax.random.normal(sample_key, shape, dtype))


def _port_model(cfg, params, dtype):
    model = GPVAE(GPVAEConfig(**dataclasses.asdict(cfg))).to(dtype)
    convert.load_flax_params(model, jax.device_get(params))
    return model


def _relnorm(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(a - ref) / np.linalg.norm(ref)


def test_bench_t100_elbo_matches_jax_fp64():
    """The preset at B=2: loss, nll and kl in float64 (a learnable prior:
    the JAX model holds a fixed prior's log-lengthscales in float32)."""
    cfg = dataclasses.replace(jconfigs.get("bench_t100").model,
                              learn_prior_lengthscales=True)
    x, times, mask = _batch(1, 2, 100)
    jmodel, params = _jax_model(cfg, x, times, mask, jnp.float64)
    key = jax.random.key(3)
    ref = jax.jit(lambda p: jmodel.apply(
        p, jnp.asarray(x), jnp.asarray(times), jnp.asarray(mask), beta=0.5,
        rngs={"sample": key}))(params)
    eps = _jax_eps(jmodel, params, key, (1, 2, 2, 100), jnp.float64)
    out = _port_model(cfg, params, torch.float64)(
        _t(x), _t(times), _t(mask, torch.bool), beta=0.5, eps=_t(eps))
    for name in ("loss", "nll", "kl"):
        assert _relnorm(getattr(out, name).detach().numpy(),
                        getattr(ref, name)) <= ELBO_FP64_REL, name


def test_bench_t100_grads_match_jax_fp32():
    """Every gradient in float32 against the JAX model's CPU route (its
    backward pins float32 and does not run in float64)."""
    cfg = jconfigs.get("bench_t100").model
    x, times, mask = _batch(2, 2, 100)
    jmodel, params = _jax_model(cfg, x, times, mask, jnp.float32)
    key = jax.random.key(4)
    args = (jnp.asarray(x, jnp.float32), jnp.asarray(times, jnp.float32),
            jnp.asarray(mask))

    def loss_fn(p):
        out = jmodel.apply(p, *args, beta=0.3, rngs={"sample": key})
        return out.loss, out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    eps = _jax_eps(jmodel, params, key, (1, 2, 2, 100), jnp.float32)
    model = _port_model(cfg, params, torch.float32)
    out = model(_t(x, torch.float32), _t(times, torch.float32),
                _t(mask, torch.bool), beta=0.3, eps=_t(eps, torch.float32))
    out.loss.backward()
    for name in ("loss", "nll", "kl"):
        assert _relnorm(getattr(out, name).detach().numpy(),
                        getattr(ref, name)) <= GRAD_FP32_REL, name
    ref_grads = {k: v.numpy() for k, v in convert.flax_to_state_dict(
        jax.device_get(jgrads["params"])).items()}
    for name, p in model.named_parameters():
        band = LOG_LS_GRAD_FP32_REL if name.endswith("log_ls") else (
            GRAD_FP32_REL)
        assert _relnorm(p.grad.numpy(), ref_grads[name]) <= band, name


def _graph_names(root):
    """Names of every autograd node reachable from ``root``."""
    seen, todo, names = set(), [root], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(fn.name())
        todo.extend(nxt for nxt, _ in fn.next_functions)
    return names


def _bench_model(t, impl="auto", dtype=torch.float64):
    cfg = dataclasses.replace(configs.get("bench_t100").model, time_len=t,
                              cov_impl=impl)
    model = GPVAE(cfg, generator=torch.Generator().manual_seed(0))
    return model.to(dtype)


@pytest.mark.parametrize("impl", ["auto", "xla"])
@pytest.mark.parametrize("t", [100, 256])
def test_chol_banks_logdets_match_logdet_from_chol(t, impl):
    """``chol_banks(logdets=True)`` gives the factors' logdets as
    ``logdet_from_chol`` of each half does, and the same factors."""
    _, times, mask = _batch(5, 2, t)
    model = _bench_model(t, impl)
    banks = model.chol_banks(_t(times), _t(mask, torch.bool), logdets=True)
    plain = model.chol_banks(_t(times), _t(mask, torch.bool))
    assert set(plain) == {"l_q", "l_p"}
    for half in ("q", "p"):
        l = banks[f"l_{half}"]
        assert torch.equal(l, plain[f"l_{half}"])
        torch.testing.assert_close(banks[f"ld_{half}"],
                                   logdet.logdet_from_chol(l),
                                   rtol=1e-12, atol=0)


@pytest.mark.parametrize("impl, dense_nodes", [("auto", 0), ("xla", 2)])
def test_elbo_graph_takes_the_logdet_gradient_in_the_cholesky_backward(
        impl, dense_nodes):
    """At T=256 (the diagonal kernel's route) the ELBO's graph has no
    ``_DiagLogdetBackward``: the logdets come out of the factorization's
    node, and their gradient joins its Cholesky backward.  The composed
    ``cov_impl="xla"`` route keeps one per half, on plain autograd."""
    x, times, mask = _batch(6, 2, 256)
    out = _bench_model(256, impl)(_t(x), _t(times), _t(mask, torch.bool),
                                  eps=_t(np.zeros((1, 2, 2, 256))))
    names = _graph_names(out.loss.grad_fn)
    assert names.count("_DiagLogdetBackward") == dense_nodes
    assert ("_CholGramBankBackward" in names) == (impl == "auto")
    assert set(out.aux) == {"l_q", "l_p", "ld_q", "ld_p"}


def test_bench_t100_preset_matches_jax():
    port, ref = configs.get("bench_t100"), jconfigs.get("bench_t100")
    assert port.model == GPVAEConfig(**dataclasses.asdict(ref.model))
    assert (port.batch_size, port.train.num_steps, port.description) == (
        ref.batch_size, ref.train.num_steps, ref.description)
    assert port.train.beta(25_000) == pytest.approx(
        float(ref.train.beta(jnp.asarray(25_000))))
    assert port.resolved_data_family == ref.resolved_data_family == "toy"


def test_cli_trains_bench_t100_at_time_len_256_on_the_cpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "gpvae_tpu_torch", "train", "--preset",
         "bench_t100", "--time-len", "256", "--steps", "3", "--batch-size",
         "4", "--device", "cpu", "--num-seqs", "10"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "done at step 3" in proc.stdout
