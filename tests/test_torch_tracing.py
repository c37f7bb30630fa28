"""The port's spans (``utils.profiling.span``) and the benchmark's readers
of them (``portbench/spans_lib.py``, ``portbench/metrics/*``), on the CPU.

* off without a profiler collecting: one shared no-op, no
  ``record_function``, no record, and nothing in a profiler's warm-up;
* under ``torch.profiler``: ``fit`` records ``gpvae.fit`` with its
  stage, indices and log point, and per step ``gpvae.step`` with its
  ``gpvae.factor``, ``gpvae.kl`` and ``gpvae.step.backward``, each with
  its parent, each child inside its parent; the profiler's own events
  nest the same way; the losses and parameters equal an untraced run's
  bit for bit; only the spans whose device interval is read record CUDA
  events (a stand-in for them on the CPU);
* ``impute`` records one ``gpvae.impute`` and one ``gpvae.posterior`` a
  call;
* ``spanned`` keeps the function's name and docstring;
* the buffer: ``clear_spans``, its bound, a span closed by an exception,
  a second thread's parents, no device interval on the CPU;
* the six span readers and the self-time arithmetic on hand-made records,
  and the cases in which they read nothing;
* ``profile_step``'s span table.
"""
import contextlib
import dataclasses
import threading
import types
from collections import deque
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from gpvae_tpu_torch import analysis, configs, profile_step, train
from gpvae_tpu_torch.data import (
    Batcher, generate_toy_data, toy_to_masked_batch,
)
from gpvae_tpu_torch.models import GPVAE, GPVAEConfig
from gpvae_tpu_torch.utils import profiling
from gpvae_tpu_torch.utils.profiling import (
    SpanRecord, clear_spans, span, spans,
)
from portbench import harness, spans_lib

T, B = 10, 4
GP_FIELDS = dict(latent_dim=2, obs_dim=15, time_len=T, prior="gp",
                 posterior="gp", prior_lengthscales=(9.0, 3.0),
                 posterior_lengthscales=(5.0, 2.0))
METRICS = Path(harness.HERE) / "metrics"


@pytest.fixture(autouse=True)
def empty_buffer():
    clear_spans()
    yield
    clear_spans()


def _config(model: str) -> GPVAEConfig:
    if model == "dense":
        return GPVAEConfig(**GP_FIELDS)
    return dataclasses.replace(configs.get("t1024_toeplitz").model,
                               time_len=T)


def _data(model: str) -> dict:
    data = toy_to_masked_batch(generate_toy_data(np.random.default_rng(0),
                                                 8, t=T))
    if model == "toeplitz":
        data["mask"][:] = True        # the Toeplitz prior's full grid
    return data


def _drain(batcher):
    """A plain generator over a Batcher: ``fit`` takes the stacked
    iterator path."""
    while True:
        yield next(batcher)


def _fit(path: str, model: str = "dense", traced: bool = False,
         steps: int = 2):
    gpvae = GPVAE(_config(model), generator=torch.Generator().manual_seed(0))
    batcher = Batcher(_data(model), B, seed=0)
    feed = batcher if path == "batcher" else _drain(batcher)
    cfg = train.TrainConfig(num_steps=steps, log_every=steps)
    ctx = (profile(activities=[ProfilerActivity.CPU]) if traced
           else contextlib.nullcontext())
    with ctx as prof:
        state, log = train.fit(gpvae, feed, cfg, device="cpu",
                               verbose=False)
    return state, log, prof


def _by_name(records) -> dict:
    out: dict[str, list] = {}
    for r in records:
        out.setdefault(r.name, []).append(r)
    return out


def test_span_is_one_shared_no_op_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert span("a") is span("b", device=True)
    with span("a"):
        with span("b"):
            pass
    assert spans() == []


def test_a_profilers_warm_up_records_nothing():
    with profile(activities=[ProfilerActivity.CPU],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        with span("warm"):
            pass
        prof.step()
        with span("active"):
            pass
        prof.step()
    assert [r.name for r in spans()] == ["active"]


@pytest.mark.parametrize("path", ["batcher", "iterator"])
def test_an_untraced_fit_records_no_span(path):
    _fit(path)
    assert spans() == []


@pytest.mark.parametrize("model, path", [("dense", "batcher"),
                                         ("dense", "iterator"),
                                         ("toeplitz", "batcher")])
def test_a_traced_fit_records_each_layer_in_its_parent(model, path):
    _fit(path, model, traced=True)
    recs = spans()
    by = _by_name(recs)
    counts = {name: len(rs) for name, rs in by.items()}
    stage = 1 if path == "batcher" else 2   # the pool once, or each call
    want = {"gpvae.fit": 1, "gpvae.fit.stage": stage, "gpvae.step": 2,
            "gpvae.factor": 2, "gpvae.kl": 2, "gpvae.step.backward": 2,
            "gpvae.fit.log": 1}
    if path == "batcher":
        want["gpvae.fit.indices"] = 1
    assert counts == want
    by_id = {r.id: r for r in recs}
    parent_of = {"gpvae.fit": None, "gpvae.step": "gpvae.fit",
                 "gpvae.step.backward": "gpvae.step"}
    for name in ("stage", "indices", "log"):
        parent_of[f"gpvae.fit.{name}"] = "gpvae.fit"
    for name in ("factor", "kl"):
        parent_of[f"gpvae.{name}"] = "gpvae.step"
    for r in recs:
        parent = by_id.get(r.parent)
        assert (parent.name if parent else None) == parent_of[r.name], r
        if parent is not None:
            assert parent.host_start_ns <= r.host_start_ns
            assert r.host_end_ns <= parent.host_end_ns
        assert r.host_start_ns < r.host_end_ns
    steps = by["gpvae.step"]
    assert steps[0].host_end_ns <= steps[1].host_start_ns


def _nearest_span(event):
    p = event.cpu_parent
    while p is not None and not p.name.startswith("gpvae."):
        p = p.cpu_parent
    return p.name if p is not None else None


@pytest.mark.parametrize("path", ["batcher", "iterator"])
def test_the_profilers_events_nest_as_the_spans(path):
    _, _, prof = _fit(path, traced=True)
    events = [e for e in prof.events() if e.name.startswith("gpvae.")]
    recs = spans()
    by_id = {r.id: r for r in recs}
    assert sorted(e.name for e in events) == sorted(r.name for r in recs)
    got = sorted((e.name, _nearest_span(e)) for e in events)
    want = sorted((r.name, by_id[r.parent].name if r.parent else None)
                  for r in recs)
    assert got == want


@pytest.mark.parametrize("path", ["batcher", "iterator"])
def test_a_traced_fit_equals_an_untraced_one_bit_for_bit(path):
    plain, plain_log, _ = _fit(path)
    traced, traced_log, _ = _fit(path, traced=True)
    assert spans()
    assert [r["loss"] for r in traced_log.rows] == \
        [r["loss"] for r in plain_log.rows]
    for (name, a), (_, b) in zip(plain.model.named_parameters(),
                                 traced.model.named_parameters()):
        assert torch.equal(a, b), name


def test_impute_records_one_impute_and_one_posterior_a_call():
    gpvae = GPVAE(_config("dense"), generator=torch.Generator().manual_seed(0))
    data = {k: torch.from_numpy(v) for k, v in _data("dense").items()}
    kept = analysis.drop_timesteps(data["mask"], 0.5,
                                   generator=torch.Generator().manual_seed(1))
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            analysis.impute(gpvae, data["x"], data["times"], data["mask"],
                            kept)
    by = _by_name(spans())
    assert sorted(by) == ["gpvae.impute", "gpvae.posterior"]
    calls, posts = by["gpvae.impute"], by["gpvae.posterior"]
    assert len(calls) == len(posts) == 3
    for post, call in zip(posts, calls):
        assert post.parent == call.id
        assert post.device_ms is None


def test_clear_spans_empties_the_buffer():
    with profile(activities=[ProfilerActivity.CPU]):
        with span("a"):
            pass
    assert len(spans()) == 1
    clear_spans()
    assert spans() == []


def test_the_buffer_keeps_the_newest_records(monkeypatch):
    assert profiling._SPANS.maxlen == profiling.SPAN_BUFFER == 65_536
    monkeypatch.setattr(profiling, "_SPANS", deque(maxlen=4))
    with profile(activities=[ProfilerActivity.CPU]):
        for i in range(10):
            with span(f"s{i}"):
                pass
    assert [r.name for r in spans()] == ["s6", "s7", "s8", "s9"]


def test_a_span_closes_on_an_exception():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with span("outer"):
                with span("inner"):
                    raise ValueError("inside")
        with span("after"):
            pass
    by = _by_name(spans())
    assert by["inner"][0].parent == by["outer"][0].id
    assert by["after"][0].parent is None


def test_a_threads_spans_have_their_own_parents():
    seen = []

    def other():
        with span("other"):
            pass
        seen.append(True)

    with profile(activities=[ProfilerActivity.CPU]):
        with span("main"):
            worker = threading.Thread(target=other)
            worker.start()
            worker.join(timeout=60)
    assert seen and not worker.is_alive()
    by = _by_name(spans())
    assert by["other"][0].parent is None


@pytest.mark.parametrize("device", [False, True])
def test_the_device_interval_is_none_on_the_cpu(device):
    with profile(activities=[ProfilerActivity.CPU]):
        with span("a", device=device):
            torch.ones(8).exp()
    (rec,) = spans()
    assert rec.device_ms is None and rec.host_ms > 0


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event`` on the CPU: the order of its
    records."""
    clock = 0

    def __init__(self, enable_timing: bool = False):
        assert enable_timing
        self.at = None

    def record(self):
        _FakeEvent.clock += 1
        self.at = _FakeEvent.clock

    def synchronize(self):
        assert self.at is not None

    def elapsed_time(self, end):
        return float(end.at - self.at)


# the spans whose device interval a reader or profile_step reads
DEVICE_SPANS = {"gpvae.step", "gpvae.step.backward", "gpvae.factor",
                "gpvae.kl", "gpvae.posterior"}


@pytest.mark.parametrize("path", ["batcher", "iterator", "impute"])
def test_only_the_device_read_spans_record_cuda_events(path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    if path == "impute":
        gpvae = GPVAE(_config("dense"),
                      generator=torch.Generator().manual_seed(0))
        data = {k: torch.from_numpy(v) for k, v in _data("dense").items()}
        with profile(activities=[ProfilerActivity.CPU]):
            analysis.impute(gpvae, data["x"], data["times"], data["mask"],
                            data["mask"])
    else:
        _fit(path, traced=True)
    recs = spans()
    assert recs
    for r in recs:
        assert (r.device_ms is not None) == (r.name in DEVICE_SPANS), r
        if r.device_ms is not None:
            assert r.device_ms > 0


def test_spanned_keeps_the_functions_name_and_docstring():
    for fn, name in ((train.fit, "fit"), (train.train_step, "train_step"),
                     (analysis.impute, "impute")):
        assert fn.__name__ == name and fn.__doc__
        assert fn.__wrapped__.__doc__ == fn.__doc__


# hand-made records of a profiled stretch: two training steps in one fit
# call, and two imputation calls (host ms start, end; device ms)
def _rec(i, name, parent, start, end, device=None):
    return SpanRecord(i, name, parent, int(start * 1e6), int(end * 1e6),
                      device)


TRAIN = [
    _rec(2, "gpvae.fit.stage", 1, 1, 11),
    _rec(3, "gpvae.fit.indices", 1, 11, 16),
    _rec(5, "gpvae.factor", 4, 17, 20, 2.0),
    _rec(6, "gpvae.kl", 4, 21, 23, 1.0),
    _rec(7, "gpvae.step.backward", 4, 24, 50, 10.0),
    _rec(4, "gpvae.step", 1, 16, 56, 40.0),
    _rec(9, "gpvae.factor", 8, 57, 60, 3.0),
    _rec(10, "gpvae.kl", 8, 61, 62, 1.0),
    _rec(11, "gpvae.step.backward", 8, 63, 80, 14.0),
    _rec(8, "gpvae.step", 1, 56, 86, 30.0),
    _rec(12, "gpvae.fit.log", 1, 86, 92),
    _rec(1, "gpvae.fit", None, 0, 100, 98.0),
]
IMPUTE = [
    _rec(2, "gpvae.posterior", 1, 1, 3, 1.5),
    _rec(1, "gpvae.impute", None, 0, 8, 4.0),
    _rec(4, "gpvae.posterior", 3, 10, 12, 2.5),
    _rec(3, "gpvae.impute", None, 9, 15, 5.0),
]
READINGS = [
    # fit's 100 ms less its steps (40 + 30) and its log point (6), a step
    ("driver_host_ms_per_step.train", TRAIN, 12.0),
    ("factor_span_ms_per_step.train", TRAIN, 2.5),
    ("kl_span_ms_per_step.train", TRAIN, 1.0),
    ("backward_span_ms_per_step.train", TRAIN, 12.0),
    ("impute_host_ms_per_call.impute", IMPUTE, 7.0),
    ("posterior_span_ms_per_call.impute", IMPUTE, 2.0),
]


def _reader(metric: str):
    return harness.load_module(METRICS / f"{metric}.py",
                               f"test_reader_{metric.replace('.', '_')}")


def _ctx(metric: str, trace=True):
    kind = metric.rsplit(".", 1)[1]
    return types.SimpleNamespace(trace=object() if trace else None,
                                 kind=kind)


@pytest.mark.parametrize("metric, records, want", READINGS,
                         ids=[m for m, _, _ in READINGS])
def test_each_span_reader_on_hand_made_records(metric, records, want,
                                              monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda: list(records))
    assert _reader(metric).read(_ctx(metric)) == pytest.approx(want)


@pytest.mark.parametrize("case", ["no stretch", "other kind",
                                  "a port without spans", "no unit span",
                                  "no device interval"])
def test_a_span_reader_reads_nothing_where_there_is_nothing(case,
                                                            monkeypatch):
    metric, records = "factor_span_ms_per_step.train", TRAIN
    ctx = _ctx(metric, trace=case != "no stretch")
    if case == "other kind":
        ctx.kind = "impute"
    if case == "a port without spans":
        monkeypatch.delattr(profiling, "spans")
    else:
        if case == "no unit span":
            records = [r for r in TRAIN if r.name != "gpvae.step"]
        if case == "no device interval":
            records = [r._replace(device_ms=None) for r in TRAIN]
        monkeypatch.setattr(profiling, "spans", lambda: list(records))
    assert _reader(metric).read(ctx) is None


def test_self_time_takes_out_only_the_named_children():
    assert spans_lib.host_self_ms(TRAIN, "gpvae.fit") == pytest.approx(100)
    assert spans_lib.host_self_ms(
        TRAIN, "gpvae.fit", less=("gpvae.step",)) == pytest.approx(30)
    # the grandchildren (factor, kl, backward) are the steps' own
    assert spans_lib.host_self_ms(
        TRAIN, "gpvae.step", less=("gpvae.factor", "gpvae.kl",
                                   "gpvae.step.backward")) == \
        pytest.approx(70 - 52)


def test_profile_step_prints_the_span_table():
    out = profile_step.profile_steps("syn_data", T, B, 2,
                                     torch.device("cpu"))
    table = out["spans_per_step"]
    assert sorted(table) == ["gpvae.factor", "gpvae.kl", "gpvae.step",
                             "gpvae.step.backward"]
    for row in table.values():
        assert row["calls"] == 1.0 and row["host_self_ms"] > 0
        assert row["device_ms"] is None
    assert profile_step.span_table(TRAIN, 2)["gpvae.fit"] == {
        "calls": 0.5, "host_self_ms": pytest.approx(9 / 2),
        "device_ms": 49.0}


def test_profile_step_runs_on_a_checkout_without_spans(monkeypatch):
    monkeypatch.delattr(profiling, "spans")
    out = profile_step.profile_steps("syn_data", T, B, 1,
                                     torch.device("cpu"))
    assert out["spans_per_step"] is None and out["top_kernels_ms_per_step"] == []
