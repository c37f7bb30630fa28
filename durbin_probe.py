#!/usr/bin/env python3
"""Measurements behind the Durbin kernels' design (``csrc/durbin.cu``).

    python3 durbin_probe.py accuracy   # CPU: the reverse's state recovery
    python3 durbin_probe.py lags       # GPU: the forward by lags a thread
    python3 durbin_probe.py barrier    # GPU: a barrier step, one late thread
    python3 durbin_probe.py time [ROOT]   # GPU: the forward of a checkout
    python3 durbin_probe.py routes     # GPU: the long route at T <= 4096

``accuracy`` runs the plain reverse (``ops.durbin.durbin_bwd_plain``, the
kernel's arithmetic: every step but the last undone by its inverse) and
the same reverse fed the forward's exact inputs at every step, and prints
each gradient's max error over its max against float64 autograd of
``durbin_plain``, on the preset's rows (T=1024) and the two near-singular
T=4096 rows ``chip_smoke.py`` checks, at the model's noise 1e-3 and at
1e-6.

``lags`` builds ``csrc/durbin.cu`` once for each width of lags a thread
that fits T=1024 in 256 threads (4, 8, 16; ``-DGPVAE_DURBIN_LAGS=P``
fixes the width) and times its forward (CUDA events, median of 7) at Z=2,
T=1024, beside the package's build (4 lags) and the chain floor.

``barrier`` builds a small kernel and reads the SM's clock over 1000
steps of: every thread loads a shared value, one thread runs ``len``
dependent float64 FMAs on it and stores the result, a barrier; at 32,
256 and 288 threads.  It prints cycles a step.

``time`` times ``durbin_cuda`` and its chain floor (CUDA events, median
of 7) at Z=2, T in {1024, 4096}, with the package imported from ROOT (a
checkout of this repository; this one by default): run it on two commits
in turns, on one card, to compare them.

``routes`` builds ``csrc/durbin.cu`` with ``-DGPVAE_DURBIN_SHORT_MAX_T=1``,
which sends every T to the long route (a window of 32 steps a launch),
holds its forward and reverse against the plain versions at T in
``ROUTE_TS`` (the preset's rows and a clamped row, random cotangents on
all three outputs), and times both routes' forward and reverse and their
chain floors at Z=2, T in {1024, 4096}, in turns (one block, long, long,
one block; CUDA events, median of 7).

Each mode prints one JSON line.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import os
import subprocess
import sys

if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "time":
    sys.path.insert(0, os.path.abspath(sys.argv[2]))

import torch  # noqa: E402

from gpvae_tpu_torch import kernels  # noqa: E402
from gpvae_tpu_torch.ops import _build, durbin  # noqa: E402

ROWS = {"T=1024 (9, 3)": (1024, (9.0, 3.0), None),
        "T=4096 l=64 unit grid": (4096, (64.0,), 1.0),
        "T=4096 l=9 grid 0..60": (4096, (9.0,), 60.0 / 4096)}


def rho_of(t, ls, step, device="cpu"):
    step = 60.0 / (t - 1) if step is None else step
    row = kernels.toeplitz_row(t, step, torch.tensor(ls, dtype=torch.float64,
                                                     device=device),
                               dtype=torch.float64)
    return (row[:, 1:] / row[:, :1]).contiguous()


def exact_states(rho):
    """Each step k's inputs ``(X, W)`` ``[N, T]`` as the forward (run again
    here, recording them) had them: ``durbin_bwd_plain``'s ``states``, so
    that the reverse runs on exact states instead of the inverse step."""
    import torch.nn.functional as F

    n, t1 = rho.shape
    x = torch.stack([torch.cat([torch.ones(n, 1, dtype=rho.dtype), rho], 1),
                     F.pad(torch.ones(n, 1, dtype=rho.dtype), (0, t1))])
    z, inputs = x, {}
    *_, (steps, _) = durbin.durbin_plain(rho, save=True)
    for k in range(1, t1 + 1):
        zz = F.pad(z[..., :-1], (1, 0))
        ab = torch.arange(t1 + 1) <= k  # the pair a lag: (a, Z b) or (s, Z t)
        inputs[k] = (torch.where(ab, x[1], x[0]), torch.where(ab, zz[1],
                                                              zz[0]))
        al = steps[None, :, 0, k - 1, None]
        x, z = x + al * zz, zz + al * x
    return inputs.__getitem__


def accuracy() -> dict:
    out = {}
    real_row = kernels.toeplitz_row
    try:
        for noise in (1e-3, 1e-6):
            kernels.toeplitz_row = lambda *a, **k: real_row(
                *a, **{**k, "noise": noise})
            for label, (t, ls, step) in ROWS.items():
                rho = rho_of(t, ls, step)
                gen = torch.Generator().manual_seed(0)
                cot = tuple(torch.randn(shape, dtype=torch.float64,
                                        generator=gen)
                            for shape in (rho.shape[:1], rho.shape,
                                          rho.shape[:1]))
                r = rho.clone().requires_grad_(True)
                outs = durbin.durbin_plain(r)
                ref, = torch.autograd.grad(
                    sum((o * c).sum() for o, c in zip(outs, cot)), r)
                *_, kept = durbin.durbin_plain(rho, save=True)
                got = {"inverse step": durbin.durbin_bwd_plain(*kept, *cot),
                       "exact states": durbin.durbin_bwd_plain(
                           *kept, *cot, states=exact_states(rho))}
                out[f"{label}, noise {noise:g}"] = {
                    name: ((g - ref).abs().max() / ref.abs().max()).item()
                    for name, g in got.items()}
    finally:
        kernels.toeplitz_row = real_row
    return out


def cuda_ms(fn, n=30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(7):
        start.record()
        for _ in range(n):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / n)
    return sorted(times)[3]


def nvcc(source, lib_path, *flags):
    """Compile ``source`` into the shared library ``lib_path`` with the
    package's flags and load it."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o",
                    str(lib_path), str(source)], check=True)
    return ctypes.CDLL(str(lib_path))


def lags() -> dict:
    dev = torch.device("cuda", 0)
    rho = rho_of(1024, (9.0, 3.0), None, dev)
    n, t1 = rho.shape
    ref = durbin.durbin_cuda(rho)
    out = {"chain_floor_ms": cuda_ms(
               lambda: durbin.chain_floor_cuda(n, t1 + 1, dev)),
           "package ms": cuda_ms(lambda: durbin.durbin_cuda(rho))}
    for p in (4, 8, 16):  # the widths that fit T=1024 in 256 threads
        lib = nvcc(_build.CSRC_DIR / "durbin.cu",
                   _build.BUILD_DIR / f"durbin_probe_lags{p}.so",
                   f"-DGPVAE_DURBIN_LAGS={p}")
        fn = lib.gpvae_durbin_f64
        fn.argtypes = durbin._ENTRY_POINTS["gpvae_durbin_f64"]
        got = tuple(torch.empty_like(v) for v in ref)

        def call(fn=fn, got=got):
            stream = torch.cuda.current_stream().cuda_stream
            if fn(rho.data_ptr(), n, t1, *(v.data_ptr() for v in got),
                  None, None, None, stream):
                raise RuntimeError(f"durbin_probe lags {p}: launch failed")

        call()
        torch.cuda.synchronize()
        err = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(got, ref))
        out[f"lags {p}"] = {"ms": cuda_ms(call), "rel_vs_default": err}
    return out


def time_forward() -> dict:
    dev = torch.device("cuda", 0)
    out = {"package": os.path.dirname(os.path.dirname(durbin.__file__))}
    for t in (1024, 4096):
        rho = rho_of(t, (9.0, 3.0), None, dev)
        out[f"T={t}"] = {
            "ms": cuda_ms(lambda rho=rho: durbin.durbin_cuda(rho)),
            "chain_floor_ms": cuda_ms(
                lambda t=t: durbin.chain_floor_cuda(2, t, dev))}
    return out


BARRIER_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void late(int iters, int len, double* out, long long* clk) {
  __shared__ double slot[2];
  double v = out[0], c = out[1];
  if (threadIdx.x == 0) slot[0] = v;
  __syncthreads();
  long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
    double a = slot[i & 1];
    if (threadIdx.x == blockDim.x - 1) {
      for (int j = 0; j < len; ++j) a = fma(a, c, c);
      slot[(i + 1) & 1] = a;
    }
    v += a;
    __syncthreads();
  }
  long long t1 = clock64();
  if (threadIdx.x == 0) { out[2] = v; clk[0] = t1 - t0; }
}
extern "C" int run(int threads, int iters, int len, void* out, void* clk) {
  late<<<1, threads>>>(iters, len, (double*)out, (long long*)clk);
  return (int)cudaGetLastError();
}
"""


def barrier() -> dict:
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = _build.BUILD_DIR / "barrier_probe.cu"
    src.write_text(BARRIER_SOURCE)
    lib = nvcc(src, _build.BUILD_DIR / "barrier_probe.so")
    lib.run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    dev = torch.device("cuda", 0)
    vals = torch.tensor([1.0, 0.999999, 0.0], dtype=torch.float64,
                        device=dev)
    clk = torch.zeros(1, dtype=torch.int64, device=dev)
    out = {}
    for threads in (32, 256, 288):
        row = {}
        for length in (0, 5, 10, 20, 40):
            for _ in range(2):  # the second run is read
                if lib.run(threads, 1000, length, vals.data_ptr(),
                           clk.data_ptr()):
                    raise RuntimeError("barrier probe: launch failed")
                torch.cuda.synchronize()
            row[f"len {length}"] = clk.item() / 1000
        out[f"{threads} threads"] = row
    return out


# the long route's sides in ``routes``: one and two steps, a ragged
# window, a ragged tile, the preset's T and the one-block kernels' largest
ROUTE_TS = (2, 3, 33, 225, 1024, 4096)


@contextlib.contextmanager
def long_route():
    """Inside the block ``ops.durbin`` launches a build of
    ``csrc/durbin.cu`` that takes every T on the long route."""
    lib = nvcc(_build.CSRC_DIR / "durbin.cu",
               _build.BUILD_DIR / "durbin_probe_long.so",
               "-DGPVAE_DURBIN_SHORT_MAX_T=1")
    lib.gpvae_cuda_error_string.restype = ctypes.c_char_p
    lib.gpvae_cuda_error_string.argtypes = [ctypes.c_int]
    for name, argtypes in durbin._ENTRY_POINTS.items():
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = argtypes
    package = _build.load("durbin", durbin._ENTRY_POINTS)
    _build._LIBS["durbin"] = lib
    try:
        yield
    finally:
        _build._LIBS["durbin"] = package


def routes() -> dict:
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from durbin_rows import clamped_rows

    dev = torch.device("cuda", 0)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp(min=1e-300)).item()

    out = {"accuracy": {}}
    with long_route():
        for t in ROUTE_TS:
            rows = {"rows": rho_of(t, (9.0, 3.0), None, dev)}
            if t > 2:
                rows["clamped"] = clamped_rows(t, device=dev)
            for label, rho in rows.items():
                n, t1 = rho.shape
                gen = torch.Generator(device=dev).manual_seed(t)
                cot = tuple(torch.randn(shape, dtype=torch.float64,
                                        device=dev, generator=gen)
                            for shape in ((n,), (n, t1), (n,)))
                *got, (steps, last) = durbin.durbin_cuda(rho, save=True)
                *ref, kept = durbin.durbin_plain(rho, save=True)
                g = durbin.durbin_bwd_cuda(steps, last, *cot)
                g_ref = durbin.durbin_bwd_plain(*kept, *cot)
                torch.cuda.synchronize()
                out["accuracy"][f"T={t} {label}"] = {
                    "forward": max(rel(a, b) for a, b in zip(got, ref)),
                    "steps": rel(steps, kept[0]), "last": rel(last, kept[1]),
                    "reverse": rel(g, g_ref)}
    for t in (1024, 4096):
        rho = rho_of(t, (9.0, 3.0), None, dev)
        n = rho.shape[0]
        gen = torch.Generator(device=dev).manual_seed(t)
        cot = tuple(torch.randn(shape, dtype=torch.float64, device=dev,
                                generator=gen)
                    for shape in ((n,), (n, t - 1), (n,)))

        def times():
            _, _, _, kept = durbin.durbin_cuda(rho, save=True)
            return {"forward_ms": cuda_ms(lambda: durbin.durbin_cuda(rho)),
                    "reverse_ms": cuda_ms(
                        lambda: durbin.durbin_bwd_cuda(*kept, *cot)),
                    "chain_floor_ms": cuda_ms(
                        lambda: durbin.chain_floor_cuda(n, t, dev)),
                    "bwd_chain_floor_ms": cuda_ms(
                        lambda: durbin.bwd_chain_floor_cuda(n, t, dev))}

        row = {"one block": [times()]}
        with long_route():
            row["long"] = [times(), times()]
        row["one block"].append(times())
        out[f"Z=2 T={t}"] = row
    return out


def main() -> int:
    modes = {"accuracy": accuracy, "lags": lags, "barrier": barrier,
             "time": time_forward, "routes": routes}
    if not (len(sys.argv) == 2 or (len(sys.argv) == 3
                                   and sys.argv[1] == "time")) \
            or sys.argv[1] not in modes:
        print(__doc__, file=sys.stderr)
        return 2
    mode = sys.argv[1]
    if mode != "accuracy" and not torch.cuda.is_available():
        print(f"durbin_probe {mode}: no CUDA device", file=sys.stderr)
        return 2
    result = modes[mode]()
    if mode != "accuracy":
        result["device"] = torch.cuda.get_device_name(0)
    print(json.dumps({mode: result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
