"""Parity of the port's kernel ops (``gpvae_tpu_torch.kernels``,
``ops.gram_chol``, ``ops.tri_inv``) with the JAX package, on the CPU.

Two routes of the JAX side are held against the port's plain versions:
* its CPU default route (``jnp.linalg.cholesky``, XLA triangular solve),
  in float64 on both sides, to 1e-9 relative;
* its Pallas kernels in interpret mode, in float32 on both sides.

Inputs are drawn with numpy from a seed and handed to both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpvae_tpu import kernels as jkernels
from gpvae_tpu.ops import pallas_chol, pallas_tri
from gpvae_tpu_torch import kernels as tkernels
from gpvae_tpu_torch.ops import gram_chol, tri_inv

FP64_REL = 1e-9
# Both sides of the float32 kernel-route comparison are float32 Cholesky
# factorizations, each 2-5e-5 from the float64 factor at T >= 45 (noise
# 1e-3 puts cond(K) near 1e4): they may differ by the sum of the two.
L_FP32_ABS = 1e-4
TRI_INV_FP32_REL = 1e-5


def _bank_inputs(seed, b, t, z=2, masked=True):
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 45.0, (b, t)), axis=-1)
    mask = np.ones((b, t), bool)
    if masked:
        mask[0, t // 2:] = False
        mask[-1, 1::3] = False
    ls = rng.uniform(1.0, 6.0, z)
    var = rng.uniform(0.5, 1.5, z)
    return times, mask, ls, var


def _rel_err(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return np.abs(a - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("kernel", sorted(tkernels.KERNELS))
def test_gram_bank_matches_jax_fp64(kernel):
    times, mask, ls, var = _bank_inputs(0, 3, 9)
    ls_bz = np.random.default_rng(1).uniform(1.0, 6.0, (3, 2))
    for lsv, v in ((ls, 1.0), (ls_bz, var)):
        ref = jkernels.gram_bank(
            jnp.asarray(times), jnp.asarray(lsv), kernel=kernel,
            variance=jnp.asarray(v), mask=jnp.asarray(mask))
        got = tkernels.gram_bank(
            torch.tensor(times), torch.tensor(lsv), kernel=kernel,
            variance=torch.tensor(v), mask=torch.tensor(mask))
        assert got.dtype == torch.float64
        assert _rel_err(got.numpy(), ref) <= FP64_REL
    # the single-grid form
    ref = jkernels.gram(jnp.asarray(times[1]), ls[0], kernel=kernel,
                        variance=var[0], mask=jnp.asarray(mask[1]))
    got = tkernels.gram(torch.tensor(times[1]), ls[0], kernel=kernel,
                        variance=var[0], mask=torch.tensor(mask[1]))
    assert _rel_err(got.numpy(), ref) <= FP64_REL


def test_kernel_codes_follow_the_cuda_enum():
    # csrc/gram_chol.cu: kRbf=0 .. kCosine=5
    assert tkernels.KERNEL_CODES == {
        "rbf": 0, "matern12": 1, "matern32": 2, "matern52": 3,
        "cauchy": 4, "cosine": 5,
    }
    with pytest.raises(ValueError, match="unknown kernel"):
        tkernels.get_kernel("periodic")


@pytest.mark.parametrize("t", [8, 45, 64])
def test_gram_chol_fused_matches_jax_default_route_fp64(t):
    times, mask, ls, var = _bank_inputs(t, 3, t)
    ref = jnp.linalg.cholesky(jkernels.gram_bank(
        jnp.asarray(times), jnp.asarray(ls), variance=jnp.asarray(var),
        mask=jnp.asarray(mask)))
    got = gram_chol.gram_chol_fused(
        torch.tensor(times), torch.tensor(ls), mask=torch.tensor(mask),
        variance=torch.tensor(var))
    assert got.shape == (3, 2, t, t)
    assert _rel_err(got.numpy(), ref) <= FP64_REL


@pytest.mark.parametrize("t", [8, 45, 64])
def test_gram_chol_fused_matches_jax_kernel_route_fp32(t):
    """The Pallas kernel (interpret mode) against the port's plain path."""
    times, mask, ls, _ = _bank_inputs(100 + t, 3, t)
    f32 = np.float32
    ref = pallas_chol.gram_chol_fused(
        jnp.asarray(times, jnp.float32), jnp.asarray(ls, jnp.float32),
        mask=jnp.asarray(mask))
    got = gram_chol.gram_chol_fused(
        torch.tensor(times.astype(f32)), torch.tensor(ls.astype(f32)),
        mask=torch.tensor(mask))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= L_FP32_ABS
    # masked steps are identity rows and columns in both
    l0 = got[0, 0].numpy()
    np.testing.assert_array_equal(np.diag(l0)[t // 2:], 1.0)


def test_gram_chol_flat_bank_broadcasting():
    """[B, Z] lengthscales and a [Z] variance land on matrix b * Z + z,
    as in pallas_chol.py:747-762."""
    times, mask, _, var = _bank_inputs(3, 3, 6)
    ls_bz = np.random.default_rng(4).uniform(1.0, 6.0, (3, 2))
    tt, mk, ls, vv = gram_chol.flat_bank(
        torch.tensor(times), torch.tensor(ls_bz), torch.tensor(mask),
        torch.tensor(var))
    assert tt.shape == (6, 6) and mk.shape == (6, 6)
    assert ls.shape == (6,) and vv.shape == (6,)
    assert all(a.dtype == torch.float32 and a.is_contiguous()
               for a in (tt, mk, ls, vv))
    for b in range(3):
        for z in range(2):
            n = b * 2 + z
            np.testing.assert_allclose(tt[n].numpy(), times[b], rtol=1e-6)
            np.testing.assert_array_equal(mk[n].numpy(), mask[b])
            assert ls[n].item() == pytest.approx(ls_bz[b, z], rel=1e-6)
            assert vv[n].item() == pytest.approx(var[z], rel=1e-6)
    ref = jnp.linalg.cholesky(jkernels.gram_bank(
        jnp.asarray(times), jnp.asarray(ls_bz), variance=jnp.asarray(var),
        mask=jnp.asarray(mask)))
    got = gram_chol.gram_chol_fused(
        torch.tensor(times), torch.tensor(ls_bz), mask=torch.tensor(mask),
        variance=torch.tensor(var))
    assert _rel_err(got.numpy(), ref) <= FP64_REL


def _factor(seed, t, n=6):
    times, mask, ls, _ = _bank_inputs(seed, n // 2, t)
    return gram_chol.gram_chol_fused(
        torch.tensor(times), torch.tensor(ls), mask=torch.tensor(mask)
    ).reshape(n, t, t)


@pytest.mark.parametrize("t", [8, 45, 64])
def test_tri_inv_matches_jax_default_route_fp64(t):
    l = _factor(200 + t, t)
    ref = jax.scipy.linalg.solve_triangular(
        jnp.asarray(l.numpy()), jnp.broadcast_to(jnp.eye(t), l.shape),
        lower=True)
    got = tri_inv.tri_inv(l)
    assert _rel_err(got.numpy(), ref) <= FP64_REL
    np.testing.assert_array_equal(np.triu(got.numpy(), 1), 0.0)


@pytest.mark.parametrize("t", [8, 45, 64])
def test_tri_inv_matches_jax_kernel_fp32(t):
    l = _factor(300 + t, t).float()
    ref = pallas_tri.tri_inv(jnp.asarray(l.numpy()))
    got = tri_inv.tri_inv(l)
    assert got.dtype == torch.float32
    assert _rel_err(got.numpy(), ref) <= TRI_INV_FP32_REL


@pytest.mark.parametrize("t", [8, 45])
def test_tri_inv_vjp_matches_jax_fp32(t):
    l = _factor(400 + t, t).float()
    x_bar = np.random.default_rng(t).standard_normal(l.shape).astype(
        np.float32)
    _, vjp = jax.vjp(pallas_tri.tri_inv, jnp.asarray(l.numpy()))
    (ref,) = vjp(jnp.asarray(x_bar))
    lt = l.clone().requires_grad_(True)
    tri_inv.tri_inv(lt).backward(torch.tensor(x_bar))
    assert _rel_err(lt.grad.numpy(), ref) <= TRI_INV_FP32_REL
    np.testing.assert_array_equal(np.triu(lt.grad.numpy(), 1), 0.0)


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor never reaches a kernel: no build, no launch."""
    before = (gram_chol.LAUNCHES, tri_inv.LAUNCHES)
    times, mask, ls, _ = _bank_inputs(5, 2, 70)  # T > 64 is fine on the CPU
    l = gram_chol.gram_chol_fused(torch.tensor(times), torch.tensor(ls),
                                  mask=torch.tensor(mask))
    tri_inv.tri_inv(l)
    assert (gram_chol.LAUNCHES, tri_inv.LAUNCHES) == before


def test_kernel_launchers_refuse_cpu_tensors():
    """The launchers take CUDA tensors only: nothing falls back."""
    l = torch.eye(4)[None]
    with pytest.raises(ValueError, match="CUDA"):
        tri_inv.tri_inv_cuda(l)
    ones = torch.ones((2, 4))
    with pytest.raises(ValueError, match="CUDA"):
        gram_chol.gram_chol_cuda(ones, ones, torch.ones(2), torch.ones(2))
