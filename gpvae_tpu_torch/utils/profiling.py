"""Tracing and profiling hooks.

Counterpart of ``gpvae_tpu/utils/profiling.py``:

* :func:`trace` -- ``torch.profiler`` around the wrapped steps, written
  as a Chrome trace that TensorBoard's profiler plugin and
  ``chrome://tracing`` read;
* :class:`StepTimer` -- steps/s and elapsed time, waiting for the device
  when asked;
* :func:`cholesky_flops` -- the useful flops of a batched factorization
  (``N T^3 / 3``);
* :func:`device_memory_stats` -- live and peak bytes of the caching
  allocator and the card's memory.
"""
from __future__ import annotations

import contextlib
import time

import torch

from gpvae_tpu_torch.utils.debug import leaves_with_path


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile everything inside the block, the host's ops and, where a
    card is present, its kernels: ``with trace("prof") as prof: ...``
    writes ``<host>_<pid>.<time>.pt.trace.json`` into ``log_dir`` and
    yields the ``torch.profiler.profile`` (``prof.key_averages()``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


class StepTimer:
    """Steps/s over the wall clock, with a wait for the device on read.

    Usage::

        timer = StepTimer()
        for batch in batches:
            metrics = train_step(state, batch, beta)
            timer.tick()
            if state.step % 500 == 0:
                print(timer.report(metrics["loss"]))
    """

    def __init__(self):
        self._t0 = time.perf_counter()
        self._ticks = 0

    def tick(self, n: int = 1) -> None:
        self._ticks += n

    def report(self, sync_on=None) -> dict:
        """``steps_per_sec``, ``elapsed_s`` and ``steps`` since the last
        report (or the start), then restart.  With ``sync_on`` (a tensor,
        or a dict or list of them) the host first waits for the device of
        each CUDA tensor in it, so the clock covers the queued work."""
        if sync_on is not None:
            for device in {leaf.device for _, leaf in leaves_with_path(sync_on)
                           if isinstance(leaf, torch.Tensor) and leaf.is_cuda}:
                torch.cuda.synchronize(device)
        now = time.perf_counter()
        dt = now - self._t0
        out = {"steps_per_sec": self._ticks / max(dt, 1e-9),
               "elapsed_s": dt, "steps": self._ticks}
        self._t0 = now
        self._ticks = 0
        return out


def cholesky_flops(n: int, t: int) -> float:
    """Useful flops of ``n`` Cholesky factorizations of side ``t``
    (``N T^3 / 3``)."""
    return n * (t ** 3) / 3.0


def device_memory_stats(device=None) -> dict:
    """``bytes_in_use`` and ``peak_bytes_in_use`` of PyTorch's caching
    allocator on ``device`` (the current CUDA device by default) and
    ``bytes_limit``, the card's memory; ``{}`` on the CPU, which has no
    such record (the JAX package's keys; its ``{}`` where a device keeps
    none)."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(
                device).total_memory}
