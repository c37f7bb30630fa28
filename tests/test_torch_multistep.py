"""Multi-step training (``steps_per_call``), the profiling and debug
utilities, and the toy-file loader of the port, against the JAX package.

* ``TrainConfig.resolved_steps_per_call`` against JAX's on the CPU;
* a k-step ``fit`` logs, checkpoints and calls back at the steps JAX's
  ``fit`` does with the same ``TrainConfig``, and ends at its step
  (overshoot included), on the Batcher and the iterator paths at T=10,
  B=4;
* k steps a call give the k=1 run's parameters bit for bit, on both
  paths, through ``make_multi_step`` and ``make_sampled_multi_step``
  directly, and across a checkpoint and resume;
* ``train --steps-per-call`` and ``train --data x.pkl`` through
  ``__main__.main``;
* ``utils``: ``StepTimer``'s keys,
  ``device_memory_stats`` on the CPU, ``check_finite`` and
  ``assert_finite`` (the same leaf path in the message), ``trace`` and
  ``enable_nan_debugging``;
* ``data.load_toy_file`` on an ``.npz`` and on a reference-format pickle
  against JAX's loader.
"""
import dataclasses
import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpvae_tpu import train as jtrain
from gpvae_tpu import utils as jutils
from gpvae_tpu.data import Batcher as JBatcher
from gpvae_tpu.data import synthetic as jsynthetic
from gpvae_tpu.models import GPVAE as JGPVAE
from gpvae_tpu.models import GPVAEConfig as JConfig
from gpvae_tpu_torch import elbo, train, utils
from gpvae_tpu_torch.__main__ import main
from gpvae_tpu_torch.data import (
    Batcher, generate_toy_data, load_toy_file, toy_to_masked_batch,
)
from gpvae_tpu_torch.models import GPVAE, GPVAEConfig

T, B = 10, 4
GP_FIELDS = dict(latent_dim=2, obs_dim=15, time_len=T, prior="gp",
                 posterior="gp", prior_lengthscales=(9.0, 3.0),
                 posterior_lengthscales=(5.0, 2.0))


def _toy(n=8, t=T, seed=0):
    return toy_to_masked_batch(generate_toy_data(np.random.default_rng(seed),
                                                 n, t=t))


def _drain(batcher):
    """A plain generator over a Batcher: hides its type, so ``fit`` takes
    the stacked iterator path."""
    while True:
        yield next(batcher)


@pytest.mark.parametrize("steps_per_call, num_steps, log_every", [
    (None, 10, 500), (None, 1, 500), (0, 10, 4), (4, 10, 4), (300, 10, 4)])
def test_resolved_steps_per_call_matches_jax_on_the_cpu(
        steps_per_call, num_steps, log_every):
    fields = dict(steps_per_call=steps_per_call, num_steps=num_steps,
                  log_every=log_every)
    ours = train.TrainConfig(**fields)
    ref = jtrain.TrainConfig(**fields)
    for resident in (False, True):
        assert ours.resolved_steps_per_call(resident) == (
            ref.resolved_steps_per_call(resident))


class _Saves:
    """A checkpoint manager that records the steps it is asked to save."""
    steps: list

    def __init__(self, directory, keep=3):
        pass

    def save(self, state):
        self.steps.append(int(state.step))

    def restore_latest(self, state):
        return None


@pytest.mark.parametrize("path", ["batcher", "iterator"])
def test_k_step_fit_logs_saves_and_calls_back_at_the_jax_steps(
        path, monkeypatch):
    """k=4 over 13 steps: calls end at 4, 8, 12, 16 (three steps past
    ``num_steps``, as JAX's scan overshoots); rows at 8, 12, 16 (a
    ``log_every`` 5 boundary crossed, or the end), saves at 8, 12 and
    after the loop, callbacks where ``step % every < k``."""
    arrays = _toy()
    # a model without a GP: the loop's step counting is the same for
    # every model, and the JAX step compiles in a third of the time
    fields = dict(latent_dim=2, obs_dim=15, time_len=T, prior="standard",
                  posterior="diag")
    config = dict(num_steps=13, log_every=5, steps_per_call=4,
                  checkpoint_every=6, checkpoint_dir="unused")
    seen = {}
    for side, lib in (("jax", jtrain), ("torch", train)):
        saves = type("Saves", (_Saves,), {"steps": []})
        monkeypatch.setattr(lib, "CheckpointManager", saves)
        calls = []
        callbacks = [(n, lambda s, step, n=n: calls.append((n, step)))
                     for n in (4, 6)]
        if side == "jax":
            batches = JBatcher(arrays, B, seed=7)
            state, log = jtrain.fit(
                JGPVAE(JConfig(**fields)),
                batches if path == "batcher" else _drain(batches),
                jtrain.TrainConfig(**config), verbose=False,
                callbacks=callbacks)
        else:
            batches = Batcher(arrays, B, seed=7)
            state, log = train.fit(
                GPVAE(GPVAEConfig(**fields)),
                batches if path == "batcher" else _drain(batches),
                train.TrainConfig(**config), device="cpu", verbose=False,
                callbacks=callbacks)
        seen[side] = {"rows": [r["step"] for r in log.rows],
                      "saves": saves.steps, "calls": calls,
                      "step": int(state.step),
                      "stream": batches._pos if path == "batcher" else None}
    assert seen["torch"] == seen["jax"]
    assert seen["jax"]["rows"] == [8, 12, 16]
    assert seen["jax"]["saves"] == [8, 12, 16]
    assert seen["jax"]["calls"] == [(4, 4), (4, 8), (6, 8), (4, 12), (6, 12),
                                    (4, 16)]


def _fit(path, k, num_steps=12, log_every=4, batcher=None, **extra):
    model = GPVAE(GPVAEConfig(**GP_FIELDS),
                  generator=torch.Generator().manual_seed(0))
    batches = batcher or Batcher(_toy(), B, seed=7)
    state, log = train.fit(
        model, batches if path == "batcher" else _drain(batches),
        train.TrainConfig(learning_rate=1e-3, num_steps=num_steps,
                          log_every=log_every, steps_per_call=k, **extra),
        device="cpu", verbose=False)
    return state, [(r["step"], r["loss"]) for r in log.rows]


def _params(state):
    return torch.cat([p.detach().reshape(-1)
                      for p in state.model.parameters()])


@pytest.mark.parametrize("path", ["batcher", "iterator"])
def test_k_steps_a_call_equal_k1_bit_for_bit(path):
    """The same kernels (here their plain versions) in the same order with
    the same generator: k=4 and k=1 end with the same bits, and log the
    same losses at 4, 8, 12."""
    ref_state, ref_rows = _fit("batcher", 1)
    state, rows = _fit(path, 4)
    assert state.step == ref_state.step == 12
    assert rows == ref_rows and [s for s, _ in rows] == [4, 8, 12]
    assert torch.equal(_params(state), _params(ref_state))


@pytest.mark.parametrize("form", ["stacked", "sampled"])
def test_multi_step_functions_equal_k_train_steps(form):
    """``make_multi_step`` over ``[k, B, ...]`` and
    ``make_sampled_multi_step`` over ``idx [k, B]`` against ``k`` calls of
    ``make_train_step``: the same bits and the last step's metrics."""
    k, arrays = 3, _toy()
    sched = elbo.BetaSchedule(init=0.5, rate=0.1, start_step=1)
    idx = np.stack([np.arange(i, i + B) for i in range(k)])
    states = []
    for _ in range(2):
        model = GPVAE(GPVAEConfig(**GP_FIELDS),
                      generator=torch.Generator().manual_seed(0))
        states.append(train.create_train_state(model, train.TrainConfig(),
                                               "cpu"))
    one = train.make_train_step(sched)
    for row in idx:
        _, want = one(states[0], train.device_arrays(
            {key: v[row] for key, v in arrays.items()}, "cpu"))
    if form == "stacked":
        multi = train.make_multi_step(sched, k)
        stacked = train.stack_batches(
            [{key: v[row] for key, v in arrays.items()} for row in idx],
            "cpu")
        _, got = multi(states[1], stacked)
        with pytest.raises(ValueError, match="holds 2 batches, not 3"):
            multi(states[1], {key: v[:2] for key, v in stacked.items()})
    else:
        multi = train.make_sampled_multi_step(sched, arrays, "cpu")
        _, got = multi(states[1], torch.from_numpy(idx))
    assert states[0].step == states[1].step == k
    assert got["beta"] == want["beta"] == sched(k - 1)
    for key in ("loss", "nll", "kl", "lengthscale_posterior"):
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(_params(states[1]), _params(states[0]))


def test_k_step_run_resumes_from_its_checkpoint_bit_for_bit(tmp_path):
    """12 steps at k=4 saving at 8 and 12, then a fresh model resumed to
    20 on the same Batcher's stream: the bits of one 20-step run."""
    ck = str(tmp_path / "ck")
    batcher = Batcher(_toy(), B, seed=7)
    first, _ = _fit("batcher", 4, num_steps=12, batcher=batcher,
                    checkpoint_every=8, checkpoint_dir=ck)
    assert first.step == 12
    assert train.CheckpointManager(ck).steps() == [8, 12]
    resumed, rows = _fit("batcher", 4, num_steps=20, batcher=batcher,
                         checkpoint_every=8, checkpoint_dir=ck)
    whole, whole_rows = _fit("batcher", 4, num_steps=20)
    assert resumed.step == whole.step == 20
    assert rows == whole_rows[-2:]
    assert torch.equal(_params(resumed), _params(whole))


def test_cli_steps_per_call_overshoots_as_jax_does(capsys):
    main(["train", "--preset", "syn_data", "--device", "cpu", "--num-seqs",
          "20", "--time-len", "12", "--batch-size", "4", "--steps", "6",
          "--steps-per-call", "4", "--log-every", "2"])
    out = capsys.readouterr().out
    assert [line.split(":")[0] for line in out.splitlines()] == [
        "step 4", "step 8", "done at step 8"]


def _reference_pickle(path, n=10, t=T):
    """The reference's ``toy_data_v3.pkl`` layout: ``x`` a list of
    ``[obs_dim, T]`` sentinel arrays, ``f``, ``time`` and ``p`` lists."""
    raw = generate_toy_data(np.random.default_rng(4), n, t=t)
    data = {"x": [np.swapaxes(s, 0, 1) for s in raw["x"]],
            "f": list(raw["f"]), "time": list(raw["time"]),
            "p": list(raw["p"])}
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return raw


@pytest.mark.parametrize("fmt", ["npz", "pkl"])
def test_load_toy_file_matches_jax(fmt, tmp_path):
    path = str(tmp_path / f"toy.{fmt}")
    if fmt == "npz":
        np.savez(path, **generate_toy_data(np.random.default_rng(4), 6, t=T))
    else:
        _reference_pickle(path)
    ours, ref = load_toy_file(path), jsynthetic.load_toy_file(path)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])
    np.testing.assert_array_equal(toy_to_masked_batch(ours)["x"],
                                  jsynthetic.toy_to_masked_batch(ref)["x"])


def test_cli_trains_on_the_reference_pickle(tmp_path, capsys):
    path = str(tmp_path / "toy_data_v3.pkl")
    raw = _reference_pickle(path, n=10, t=45)
    np.testing.assert_array_equal(
        toy_to_masked_batch(load_toy_file(path))["x"],
        toy_to_masked_batch(raw)["x"])
    main(["train", "--preset", "syn_data", "--data", path, "--device", "cpu",
          "--steps", "2", "--batch-size", "4"])
    assert "done at step 2" in capsys.readouterr().out


def test_step_timer_reports_the_jax_keys():
    ours, ref = utils.StepTimer(), jutils.StepTimer()
    for timer in (ours, ref):
        timer.tick()
        timer.tick(9)
    got = ours.report(sync_on={"loss": torch.ones(())})
    want = ref.report(jnp.ones(()))
    assert sorted(got) == sorted(want)
    assert got["steps"] == want["steps"] == 10
    assert got["steps_per_sec"] > 0 and got["elapsed_s"] > 0
    assert ours.report()["steps"] == 0


def test_device_memory_stats_is_empty_on_the_cpu():
    assert utils.device_memory_stats("cpu") == {}
    if not torch.cuda.is_available():
        assert utils.device_memory_stats() == {}
    assert isinstance(jutils.device_memory_stats(), dict)


def _trees(bad: bool, lib):
    w = np.array([1.0, np.nan if bad else 2.0, 3.0], np.float32)
    as_array = torch.from_numpy if lib == "torch" else jnp.asarray
    return {"enc": {"w": as_array(w), "b": as_array(np.zeros(2, np.float32))},
            "steps": [as_array(np.arange(3))], "ls": [as_array(np.ones(2))]}


@pytest.mark.parametrize("bad", [False, True])
def test_check_finite_matches_jax(bad):
    got = utils.check_finite(_trees(bad, "torch"), "params")
    assert got.dtype == torch.bool and got.shape == ()
    assert bool(got) == bool(jutils.check_finite(_trees(bad, "jax"),
                                                 "params")) == (not bad)
    assert bool(utils.check_finite({"ints": torch.arange(3)}))


def test_assert_finite_names_the_leaf_as_jax_does():
    utils.assert_finite(_trees(False, "torch"), "params")
    with pytest.raises(FloatingPointError) as ours:
        utils.assert_finite(_trees(True, "torch"), "params")
    with pytest.raises(FloatingPointError) as ref:
        jutils.assert_finite(_trees(True, "jax"), "params")
    assert str(ours.value) == str(ref.value) == (
        "non-finite values in params['enc']['w']")
    model = GPVAE(GPVAEConfig(**GP_FIELDS))
    with torch.no_grad():
        model.posterior_log_ls[0] = float("inf")
    with pytest.raises(FloatingPointError,
                       match=r"^non-finite values in model\['posterior_"):
        utils.assert_finite(model, "model")


def test_trace_writes_a_chrome_trace_and_nan_debugging_toggles(tmp_path):
    with utils.trace(str(tmp_path)) as prof:
        torch.ones(4).exp().sum()
    assert prof.key_averages()
    (path,) = tmp_path.iterdir()
    assert path.name.endswith(".pt.trace.json")
    assert json.loads(path.read_text())["traceEvents"]
    was = torch.is_anomaly_enabled()
    try:
        utils.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        utils.enable_nan_debugging(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(was)


def test_fit_resolves_k_from_the_config():
    """``steps_per_call`` None runs one step a call: 13 steps end at 13."""
    state, rows = _fit("iterator", None, num_steps=13, log_every=5)
    assert state.step == 13 and [s for s, _ in rows] == [5, 10, 13]
    assert dataclasses.asdict(train.TrainConfig())["steps_per_call"] is None
