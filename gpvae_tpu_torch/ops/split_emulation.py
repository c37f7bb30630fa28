"""The arithmetic of the panel tile's tensor-core products
(``csrc/gram_panel.cu``), emulated on the CPU with numpy, at the shapes
the T=1024 path gives them, and on evaluate's T=4096 gram.

The tile multiplies float32 operands as TF32 parts: ``a b = al bh + ah bl
+ ah bh`` with ``ah = rna(a)``, ``al = rna(a - ah)`` (10 mantissa bits,
rounded to nearest), summed by the tensor cores in float32 with
truncation, so each 32-deep stage sums into fresh accumulators that an
ordinary float32 add rounds into the total.  Products of TF32 parts are
exact in float64; the truncating sum is emulated per 8-deep step.  The
stages run from the history's last columns back to its first, and its
first 32 columns are summed apart by float32 FMA and added last
(``order="tile"``, gram_panel's and hist_panel's); ``order="forward"``,
every column on the tensor cores first column first, is trail_update's
and was theirs before.

Run ``python -m gpvae_tpu_torch.ops.split_emulation`` (a few minutes on
one core; ``--t4096`` adds the T=4096 factorization, about five more); it
prints one JSON object:

* ``split``: the largest relative error of ``ah + al`` over float32
  values of every magnitude, and its mean over its mean magnitude (a
  bias);
* ``panel``: the middle step of the T=1024 factorization (o=512, w=128)
  on the port's float32 factor, against float64: a float32 FMA loop
  (the SIMT tile), 3xTF32 with the per-stage rounding (the tile) and
  without it (one truncated sum);
* ``factor_vs_library``: the blocked factorization of pre-built banks
  with each of those panel products (float32 diagonal factors and solves
  by torch), its largest error from float64 over the library's float32
  factor's;
* ``trail_panel``: ``X = P Ld^-T`` of the right-looking route's middle
  step (o=384, nb=128) against the explicit inverse, where the product
  cancels, by the float32 FMA loop and by 3xTF32;
* with ``--t4096``, ``factor_vs_library_t4096``: the same on the
  ``sparse_t4096`` evaluate's gram (T=4096, one sequence of the CLI's toy
  times, half its observed steps kept, lengthscale 256, the jitter 1e-5),
  for the FMA loop and both orders of the tile, each also with its
  history summed from the last columns back;
* with ``--backward``, ``backward``: the three passes of the Cholesky
  backward's kernel (``csrc/chol_bwd.cu``) on the port's float32 factor at
  T=1024, N=2, a cotangent and a logdet cotangent drawn from the seed:
  each pass alone on float32 inputs against its float64 product
  (``passes``, and its mean error away from zero, ``bias``), and the
  whole ``K_bar`` against float64 (``k_bar``), each route's largest error
  over the FMA loop's (``ratio``), for the FMA loop, both orders of the
  tile and the kernel's (:data:`BACKWARD_ROUTES`).
  The passes multiply over each tile row's or column's own depth, from
  the triangle's first nonzero column, as the kernel does.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from gpvae_tpu_torch import kernels as kernels_lib
from gpvae_tpu_torch.ops import blocked

T, N, NB = 1024, 2, 128
STAGE = 32


def tf32_rna(x):
    """``x`` rounded to TF32, to nearest, ties away from zero."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_trunc(x):
    """What the tensor cores read of a float32 operand: its top 10
    mantissa bits."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def split2(x):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def _to_f32_rz(x):
    """float64 to float32 toward zero: the tensor cores' sum."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(y, np.float32(0)), y)


def _mma_sum(pairs, depth, flush, shape):
    """``sum_k A[..., m, k] B[..., c, k]`` over the (A part, B part) pairs,
    8 deep a step summed with truncation, into fresh accumulators every
    ``flush`` deep that are then rounded into a float32 total."""
    total = np.zeros(shape, np.float32)
    for k0 in range(0, depth, flush):
        part = np.zeros(shape, np.float32)
        for s in range(k0, min(depth, k0 + flush), 8):
            sl = slice(s, s + 8)
            for a, b in pairs:
                p = np.einsum("nmk,nck->nmc",
                              tf32_trunc(a[..., sl]).astype(np.float64),
                              tf32_trunc(b[..., sl]).astype(np.float64))
                part = _to_f32_rz(part.astype(np.float64) + p)
        total = (total.astype(np.float64) + part).astype(np.float32)
    return total


def _tensor_sum(a, b, flush):
    ah, al = split2(a)
    bh, bl = split2(b)
    return _mma_sum([(al, bh), (ah, bl), (ah, bh)], a.shape[2], flush,
                    (a.shape[0], a.shape[1], b.shape[1]))


def _last_first(x):
    """The depth of ``x [..., K]`` in stages of ``STAGE`` taken from the
    last back to the first (the top stage, ragged, padded with zeros to a
    whole one, whose exact zero products change no sum)."""
    k = x.shape[-1]
    pad = (-k) % STAGE
    x = np.concatenate([x, np.zeros(x.shape[:-1] + (pad,), x.dtype)], -1)
    stages = x.reshape(x.shape[:-1] + (-1, STAGE))[..., ::-1, :]
    return np.ascontiguousarray(stages.reshape(x.shape))


def product_3xtf32(a, b, flush=STAGE, order="tile"):
    """``a [N, M, K] @ b [N, C, K]^T`` as the tile computes it (``order``:
    see the module's doc); ``flush`` = K sums the tensor cores' depth in
    one truncated accumulator."""
    if order == "forward":
        return _tensor_sum(a, b, flush)
    head = product_fma(a[..., :STAGE], b[..., :STAGE])
    if a.shape[2] <= STAGE:
        return head
    rest = _tensor_sum(_last_first(a[..., STAGE:]),
                       _last_first(b[..., STAGE:]), flush)
    return (rest.astype(np.float64) + head).astype(np.float32)


def product_fma(a, b):
    """The same product as a float32 FMA loop over the depth."""
    acc = np.zeros((a.shape[0], a.shape[1], b.shape[1]), np.float32)
    for k in range(a.shape[2]):
        acc = (acc.astype(np.float64) + a[..., k, None].astype(np.float64)
               * b[:, None, :, k].astype(np.float64)).astype(np.float32)
    return acc


def bank_inputs(seed):
    """Masked bank inputs ``times, mask [N, T]``, ``ls, var [N]`` as
    ``chip_smoke.py``'s pre-built banks (lengthscales 1-10 over a span of
    60), as torch tensors in float64."""
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 60.0, (N, T)), axis=-1)
    mask = rng.random((N, T)) > rng.uniform(0.0, 0.7, (N, 1))
    mask[:, 0] = True
    return (torch.tensor(times), torch.tensor(mask),
            torch.tensor(rng.uniform(1.0, 10.0, N)),
            torch.tensor(rng.uniform(0.5, 1.5, N)))


def bank64(seed):
    """The gram bank ``[N, T, T]`` of :func:`bank_inputs` in float64."""
    times, mask, ls, var = bank_inputs(seed)
    return kernels_lib.gram(times, ls[:, None, None],
                            variance=var[:, None, None], mask=mask).numpy()


def port_factor32(seed):
    """The port's float32 factor of that bank, by its plain route."""
    times, mask, ls, var = bank_inputs(seed)
    return blocked.cholesky_gram_inplace(times.float(), ls.float(), mask,
                                         var.float()).numpy()


def factor(k32, product):
    """The left-looking blocked factorization of ``k32 [N, T, T]`` in
    float32 with ``product`` for each panel's history."""
    l = np.zeros_like(k32)
    t = k32.shape[-1]
    for o in range(0, t, NB):
        w = min(NB, t - o)
        panel = k32[:, o:, o:o + w].copy()
        if o:
            panel -= product(l[:, o:, :o], l[:, o:o + w, :o])
        ld = torch.linalg.cholesky(torch.from_numpy(panel[:, :w]))
        l[:, o:o + w, o:o + w] = ld.numpy()
        if o + w < t:
            x = torch.linalg.solve_triangular(
                ld, torch.from_numpy(panel[:, w:]).mT, upper=False).mT
            l[:, o + w:, o:o + w] = x.numpy()
    return l


def evaluate_gram_t4096():
    """``[1, 4096, 4096]``: the gram ``posterior_conditional`` factors for
    one sequence of ``sparse_t4096``'s CLI toy data (seed 3), half its
    observed steps kept (seed 10), lengthscale 256, plus 1e-5 I."""
    from gpvae_tpu_torch.data import generate_toy_data, toy_to_masked_batch

    t = 4096
    batch = toy_to_masked_batch(generate_toy_data(np.random.default_rng(3),
                                                  2, t=t))
    kept = batch["mask"] & (np.random.default_rng(10).random((2, t)) >= 0.5)
    f64 = torch.float64
    k = kernels_lib.gram_bank(torch.tensor(batch["times"][:1], dtype=f64),
                              torch.tensor([256.0], dtype=f64),
                              mask=torch.tensor(kept[:1]))
    return (k + 1e-5 * torch.eye(t, dtype=torch.float64)).reshape(
        1, t, t).numpy()


def _reversed(product):
    """``product`` with the history's columns taken last first."""
    return lambda a, b: product(np.ascontiguousarray(a[..., ::-1]),
                                np.ascontiguousarray(b[..., ::-1]))


def t4096_ratios() -> dict:
    k64 = evaluate_gram_t4096()
    l64 = np.linalg.cholesky(k64)
    k32 = k64.astype(np.float32)
    err_lib = np.abs(torch.linalg.cholesky(torch.from_numpy(k32)).numpy()
                     - l64).max()
    forward = lambda a, b: product_3xtf32(a, b, order="forward")  # noqa
    routes = {"fma": product_fma, "fma_last_first": _reversed(product_fma),
              "tile_forward": forward,
              "tile_forward_last_first": _reversed(forward),
              "tile": product_3xtf32}
    return {name: float(np.abs(factor(k32, fn) - l64).max() / err_lib)
            for name, fn in routes.items()}


def mirror_lower(w):
    """``w [N, T, T]``'s lower triangle, mirrored above: what the kernel's
    first pass keeps of a diagonal tile."""
    low = np.tril(w)
    return low + np.tril(w, -1).transpose(0, 2, 1)


def mirror_tiles(k):
    """``k``'s lower tiles of ``NB``, mirrored above, each diagonal tile
    averaged with its transpose: what the kernel's third pass stores."""
    n, t, _ = k.shape
    out = np.zeros_like(k)
    for j0 in range(0, t, NB):
        d = k[:, j0:j0 + NB, j0:j0 + NB]
        out[:, j0:j0 + NB, j0:j0 + NB] = (
            0.5 * (d.astype(np.float64) + d.transpose(0, 2, 1))
        ).astype(k.dtype)
        below = k[:, j0 + NB:, j0:j0 + NB]
        out[:, j0 + NB:, j0:j0 + NB] = below
        out[:, j0:j0 + NB, j0 + NB:] = below.transpose(0, 2, 1)
    return out


def pass_w(l, l_bar, g, product):
    """First pass: ``W = 1/2 L^T L_bar`` on the lower tiles, row tile i0
    over the depth k >= i0, mirrored, ``g`` on the diagonal."""
    n, t, _ = l.shape
    lt = np.ascontiguousarray(l.transpose(0, 2, 1))
    bt = np.ascontiguousarray(l_bar.transpose(0, 2, 1))
    p = np.zeros_like(l)
    for i0 in range(0, t, NB):
        p[:, i0:i0 + NB, :i0 + NB] = product(lt[:, i0:i0 + NB, i0:],
                                             bt[:, :i0 + NB, i0:])
    w = mirror_lower(p * p.dtype.type(0.5))
    idx = np.arange(t)
    w[:, idx, idx] += g[:, None].astype(w.dtype)
    return w


def pass_m(x, w, product):
    """Second pass: ``M = X^T W`` (W symmetric), row tile i0 over the
    depth k >= i0."""
    n, t, _ = x.shape
    xt = np.ascontiguousarray(x.transpose(0, 2, 1))
    m = np.zeros_like(x)
    for i0 in range(0, t, NB):
        m[:, i0:i0 + NB] = product(xt[:, i0:i0 + NB, i0:], w[:, :, i0:])
    return m


def pass_k(m, x, product):
    """Third pass: ``K_bar = M X`` on the lower tiles, column tile j0 over
    the depth k >= j0, mirrored (:func:`mirror_tiles`)."""
    n, t, _ = x.shape
    xt = np.ascontiguousarray(x.transpose(0, 2, 1))
    k = np.zeros_like(x)
    for j0 in range(0, t, NB):
        k[:, j0:, j0:j0 + NB] = product(np.ascontiguousarray(m[:, j0:, j0:]),
                                        xt[:, j0:j0 + NB, j0:])
    return mirror_tiles(k)


def backward_inputs(seed, t=T, n=N):
    """The port's float32 factor of :func:`bank_inputs`' bank (T = 1024
    only; smaller sides cut it to a leading block, itself a factor), its
    float32 inverse, a lower-triangular N(0, 1) cotangent and a logdet
    cotangent per matrix, drawn from ``seed``."""
    l = port_factor32(seed)[:n, :t, :t].copy()
    x = torch.linalg.solve_triangular(
        torch.from_numpy(l), torch.eye(t).expand(n, t, t),
        upper=False).numpy()
    rng = np.random.default_rng(seed)
    l_bar = np.tril(rng.standard_normal((n, t, t))).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    return l, x, l_bar, g


def _max_err(got, ref):
    return float(np.abs(got.astype(np.float64) - ref).max())


def _bias(got, ref):
    """The mean error away from zero, over the mean magnitude."""
    err = (got.astype(np.float64) - ref) * np.sign(ref)
    return float(err.mean() / np.abs(ref).mean())


def backward_errors(seed, routes, t=T, n=N) -> dict:
    """Each route's largest error, per pass on shared float32 inputs and
    for the whole ``K_bar``, against float64, and each pass's ``bias``
    (:func:`_bias`); ``ratio``: the largest errors over the FMA loop's
    (``routes["fma"]``).  A route is one product for the three passes, or
    a triple, one for each."""
    l, x, l_bar, g = backward_inputs(seed, t, n)
    exact = lambda a, b: (a.astype(np.float64)  # noqa: E731
                          @ b.astype(np.float64).transpose(0, 2, 1))
    w64 = pass_w(l.astype(np.float64), l_bar.astype(np.float64),
                 g.astype(np.float64), exact)
    w32 = w64.astype(np.float32)
    m64 = pass_m(x.astype(np.float64), w32.astype(np.float64), exact)
    m32 = m64.astype(np.float32)
    k64 = pass_k(m32.astype(np.float64), x.astype(np.float64), exact)
    x64 = np.linalg.inv(l.astype(np.float64))
    kbar64 = x64.transpose(0, 2, 1) @ w64 @ x64
    out = {"passes": {}, "bias": {}, "k_bar": {}}
    for name, route in routes.items():
        fw, fm, fk = route if isinstance(route, tuple) else (route,) * 3
        got = {"w": (pass_w(l, l_bar, g, fw), w64),
               "m": (pass_m(x, w32, fm), m64), "k": (pass_k(m32, x, fk), k64)}
        out["passes"][name] = {p: _max_err(*v) for p, v in got.items()}
        out["bias"][name] = {p: _bias(*v) for p, v in got.items()}
        kbar = pass_k(pass_m(x, pass_w(l, l_bar, g, fw), fm), x, fk)
        out["k_bar"][name] = _max_err(kbar, kbar64)
    fma = out["passes"]["fma"]
    out["ratio"] = {
        name: {**{p: e / fma[p] for p, e in errs.items()},
               "k_bar": out["k_bar"][name] / out["k_bar"]["fma"]}
        for name, errs in out["passes"].items()}
    return out


def _forward(flush):
    return lambda a, b: product_3xtf32(a, b, flush, order="forward")


# the routes --backward compares: the FMA loop; the panel tile's order and
# the forward order, each stage summed into fresh accumulators; and the
# kernel's: forward, the first pass into fresh accumulators every 8 deep
# (one wgmma k-step of its three products)
BACKWARD_ROUTES = {
    "fma": product_fma,
    "tile": product_3xtf32,
    "forward": _forward(STAGE),
    "kernel": (_forward(8), _forward(STAGE), _forward(STAGE)),
}


def main() -> None:
    import sys

    if "--backward" in sys.argv[1:]:
        print(json.dumps({"backward": backward_errors(5, BACKWARD_ROUTES)}))
        return

    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000)
         * 10.0 ** rng.uniform(-20, 20, 100_000)).astype(np.float32)
    hi, lo = split2(x)
    x64 = x.astype(np.float64)
    rel = (hi.astype(np.float64) + lo - x64) / np.abs(x64)
    out = {"split": {"max_rel": float(np.abs(rel).max()),
                     "bias": float(rel.mean() / np.abs(rel).mean())}}

    routes = {"fma": product_fma, "3xtf32": product_3xtf32,
              "3xtf32_one_sum": lambda a, b: product_3xtf32(a, b,
                                                            a.shape[2])}
    l32 = port_factor32(2)
    o, w = 512, NB
    a, b = l32[:, o:, :o], l32[:, o:o + w, :o]
    ref = np.einsum("nmk,nck->nmc", a.astype(np.float64),
                    b.astype(np.float64))
    out["panel"] = {name: float(np.abs(fn(a, b) - ref).max())
                    for name, fn in routes.items()}

    ratios = {name: [] for name in routes}
    for seed in (2, 3):
        k64 = bank64(seed)
        l64 = np.linalg.cholesky(k64)
        k32 = k64.astype(np.float32)
        lib = torch.linalg.cholesky(torch.from_numpy(k32)).numpy()
        err_lib = np.abs(lib - l64).max()
        for name, fn in routes.items():
            ratios[name].append(float(np.abs(factor(k32, fn) - l64).max()
                                      / err_lib))
    out["factor_vs_library"] = ratios

    o, nb = 384, NB
    l64 = l32.astype(np.float64)
    ld = l64[:, o:o + nb, o:o + nb]
    # P such that X is the factor's column block
    p = l64[:, o + nb:, o:o + nb] @ ld.transpose(0, 2, 1)
    p = p.astype(np.float32)
    inv = np.tril(np.linalg.inv(ld)).astype(np.float32)
    ref = np.einsum("nmk,nck->nmc", p.astype(np.float64),
                    inv.astype(np.float64))
    out["trail_panel"] = {
        "fma": float(np.abs(product_fma(p, inv) - ref).max()),
        "3xtf32": float(np.abs(product_3xtf32(p, inv, order="forward")
                               - ref).max())}
    if "--t4096" in sys.argv[1:]:
        out["factor_vs_library_t4096"] = t4096_ratios()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
