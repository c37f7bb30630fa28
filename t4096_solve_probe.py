"""Where an evaluate path's posterior mean loses its float32 accuracy on
the card.

Trains ``sparse_t4096`` (T=4096) as ``chip_smoke.py`` phase 4h does, or
with ``--preset t1024_toeplitz`` that preset (T=1024 on fully observed
sequences) as phase 4i does, takes the posterior mean ``A^T alpha`` of
evaluate's first batch (``[A, alpha] = L^{-1} [K_oq, z]``, ``L`` the
factor of ``K_oo + 1e-5 I``) and swaps each of its three parts between
places, printing each combination's max abs error over the largest entry
of the float64 mean, as JSON:

* the factor ``L``: the port's kernels, cuSOLVER, or the CPU's float32
  (the port's blocked route with the plain versions, or LAPACK);
* the triangular solve: the library on the card in float32, the port's
  explicit-inverse route on the card (``tri_inv``, then one product: the
  route evaluate takes up to T=2048), the library on the CPU in float32,
  or on the card in float64;
* the product ``A^T alpha``: on the card, on the CPU, or in float64;

and the mean as evaluate takes it on the card's inverse route, ``K_qo (L
L^T)^{-1} z`` from two solves of the single column ``z``
(``ops.trsm.cho_solve_by_inverse``), on each factor: the inverse route
refined by its residual (the port's), unrefined, the library's
substitution on the card, and float64.

Needs one CUDA device; run from the root of a checkout:

    python3 t4096_solve_probe.py [--preset t1024_toeplitz]
"""
import argparse
import itertools
import json
import os
import sys
import tempfile

import torch

import chip_smoke as cs
from gpvae_tpu_torch import analysis, kernels as kernels_lib
from gpvae_tpu_torch.data import Batcher
from gpvae_tpu_torch.ops import (
    _build, blocked, chol, chol_block, durbin, gram_chol, logdet, trail,
    tri_inv, trsm,
)


# preset: (T, steps, eval batch, training data, probe batch)
PATHS = {
    "sparse_t4096": (cs.SPARSE_T, cs.SPARSE_STEPS, cs.SPARSE_EVAL_B,
                     lambda: Batcher(cs.sparse_batch(0, cs.SPARSE_SEQS),
                                     cs.SPARSE_B, seed=0),
                     lambda: cs.sparse_batch(1, 8)),
    "t1024_toeplitz": (cs.TOEP_T, cs.TOEP_STEPS, cs.TOEP_EVAL_B,
                       lambda: Batcher(cs.toy_full_batch(0, cs.TOEP_SEQS,
                                                         cs.TOEP_T),
                                       cs.TOEP_B, seed=0),
                       lambda: cs.toy_full_batch(1, 8, cs.TOEP_T)),
}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", choices=sorted(PATHS),
                        default="sparse_t4096")
    preset = parser.parse_args().preset
    if not torch.cuda.is_available():
        print("t4096_solve_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    _build.build_all(cs.SOURCES)
    for module in (gram_chol, tri_inv, chol_block, blocked, logdet, trail,
                   durbin):
        module.build()
    t, steps, eval_b, data, probe = PATHS[preset]
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="_smoke_ckpt_", dir=root) as ck:
        model, _, _ = cs.train_path(dev, preset, t, steps, None, ck,
                                    data=(data(), probe()))
    batch = cs.eval_batch(preset, t, eval_b)
    kept = analysis.drop_timesteps(torch.tensor(batch["mask"]), 0.5,
                                   generator=torch.Generator().manual_seed(0))
    cfg = model.config
    with torch.no_grad():
        z = analysis._mean(model, torch.tensor(batch["x"], device=dev))
        ls = torch.exp(model.prior_log_ls).float()

    def parts(device, dtype):
        """``K_oo + 1e-5 I`` and ``[K_oq, z]`` as posterior_conditional
        builds them."""
        times = torch.tensor(batch["times"], dtype=dtype, device=device)
        mask = kept.to(device)
        gram = dict(kernel=cfg.kernel, noise=cfg.noise)
        k_oo = kernels_lib.gram_bank(times, ls.to(device, dtype),
                                     mask=mask, **gram)
        k_oo = k_oo + 1e-5 * torch.eye(times.shape[-1], dtype=dtype,
                                       device=device)
        k_oq = kernels_lib.cross_gram(times, times, ls.to(device, dtype),
                                      mask_a=mask, **gram)
        zz = (z.to(device, dtype) * mask[..., None]).mT[..., None]
        return k_oo, torch.cat([k_oq, zz], -1)

    with torch.no_grad():
        k64, rhs64 = parts(dev, torch.float64)
        s64 = torch.linalg.solve_triangular(torch.linalg.cholesky(k64),
                                            rhs64, upper=False)
        ref = (s64[..., :-1].mT @ s64[..., -1:])[..., 0]
        scale = ref.abs().max().item()
        del k64, rhs64, s64
        k32, rhs32 = parts(dev, torch.float32)
        k_cpu, _ = parts("cpu", torch.float32)
        factors = {"kernels": chol.cholesky(k32),
                   "cusolver": torch.linalg.cholesky(k32),
                   "cpu_blocked": chol.cholesky(k_cpu).to(dev),
                   "cpu_lapack": torch.linalg.cholesky(k_cpu).to(dev)}
        solves = {
            "card": lambda l: torch.linalg.solve_triangular(
                l, rhs32, upper=False),
            "inverse": lambda l: trsm.solve_triangular(
                l.contiguous(), rhs32, via_inverse=True),
            "cpu": lambda l: torch.linalg.solve_triangular(
                l.cpu(), rhs32.cpu(), upper=False).to(dev),
            "float64": lambda l: torch.linalg.solve_triangular(
                l.double(), rhs32.double(), upper=False).float()}
        products = {
            "card": lambda a, al: a.mT @ al,
            "cpu": lambda a, al: (a.cpu().mT @ al.cpu()).to(dev),
            "float64": lambda a, al: a.double().mT @ al.double()}
        out = {}
        # the mean as evaluate takes it on the card, K_qo (L L^T)^-1 z:
        # two products of the single column z with one inverse
        # (trsm.cho_solve_by_inverse, refined by the residual), and the
        # same two products unrefined
        k_oq, zz = rhs32[..., :-1], rhs32[..., -1:]

        def inverse_unrefined(l):
            x_inv = tri_inv.tri_inv(l.contiguous())
            return x_inv.mT @ (x_inv @ zz)

        cho = {"inverse refined (cho_solve_by_inverse)":
               lambda l: trsm.cho_solve_by_inverse(l.contiguous(), zz),
               "inverse": inverse_unrefined,
               "card": lambda l: torch.linalg.solve_triangular(
                   l.mT, torch.linalg.solve_triangular(l, zz, upper=False),
                   upper=True),
               "float64": lambda l: torch.cholesky_solve(
                   zz.double(), l.double()).float()}
        for f, (name, solve) in itertools.product(factors, cho.items()):
            mean = (k_oq.mT @ solve(factors[f]))[..., 0]
            out[f"K_qo w: factor {f}, solve {name}"] = (
                (mean.double() - ref).abs().max() / scale).item()
        for f, s in itertools.product(factors, solves):
            solved = solves[s](factors[f])
            for p, product in products.items():
                mean = product(solved[..., :-1], solved[..., -1:])[..., 0]
                out[f"factor {f}, solve {s}, product {p}"] = (
                    (mean.double() - ref).abs().max() / scale).item()
            del solved
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
