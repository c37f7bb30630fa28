"""Runs of every cell on the CPU at a small size, the look for a card
skipped: a sound run comes out correct; a run with the timed path broken
underneath, and the control, come out not correct.  And what a run may
load: never JAX or the JAX package."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from portbench import control, harness
from portbench.reference import gpvae as ref

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SMALL = {"train": dict(time_len=16, pool=128, chunk_steps=2),
         "impute": dict(time_len=16, pool_calls=3, seqs_per_call=4)}
CELLS = ["bench_t100.train.t1024", "t1024_toeplitz.train.t8192",
         "bench_t100.impute.t1024", "t1024_toeplitz.impute.t8192"]
SEED = 2 ** 31 + 12345


def small(name: str):
    cell = harness.load_cell(name)
    cell.mix.update(SMALL[cell.kind])
    if cell.mix["xmax"] > 60:
        cell.mix["xmax"] = 15.0             # the unit grid at T=16
    return cell


def run(name: str) -> dict:
    return harness.run_cell(small(name), SEED, 0.3, False, CPU,
                            time.monotonic())


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = run(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    cell = harness.load_cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end()}


def half_batch_forward(real):
    def forward(self, x, times=None, mask=None, **kw):
        h = x.shape[0] // 2
        return real(self, x[:h], times[:h], None if mask is None else mask[:h],
                    **kw)
    return forward


@pytest.mark.parametrize("name", CELLS[:2])
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(name,
                                                                 monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    res = run(name)
    assert not res["correct"]
    assert res["checks"]["update_gap_median"]["value"] == 1.0


@pytest.mark.parametrize("name", CELLS[:2])
def test_half_the_batch_left_out_is_not_correct(name, monkeypatch):
    from gpvae_tpu_torch.models import GPVAE

    monkeypatch.setattr(GPVAE, "forward", half_batch_forward(GPVAE.forward))
    assert not run(name)["correct"]


@pytest.mark.parametrize("name", CELLS[2:])
def test_an_altered_answer_is_not_correct(name, monkeypatch):
    from gpvae_tpu_torch import analysis

    real = analysis.impute

    def altered(*args, **kw):
        probs, z, post = real(*args, **kw)
        probs = probs.clone()
        probs[0, 0, 0] = 1.0 - probs[0, 0, 0]
        return probs, z, post

    monkeypatch.setattr(analysis, "impute", altered)
    res = run(name)
    assert not res["correct"]
    assert res["checks"]["probs_gap"]["value"] > 1e-3


@pytest.mark.parametrize("name", CELLS[2:3])
def test_half_the_batch_imputed_is_not_correct(name, monkeypatch):
    from gpvae_tpu_torch import analysis

    real = analysis.impute

    def half(model, x, times, mask, kept, **kw):
        h = x.shape[0] // 2
        probs, z, post = real(model, x[:h], times[:h], mask[:h], kept[:h], **kw)
        return (torch.cat([probs, torch.zeros_like(probs)]),
                torch.cat([z, torch.zeros_like(z)]), post)

    monkeypatch.setattr(analysis, "impute", half)
    assert not run(name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The plain reference in the program's place at TF32 products, the
    precision one step below the configuration's float32."""
    rows = control.readings(small(name), SEED, 0.3, True, CPU)
    got = {r["role"]: r["readings"] for r in rows}
    limits = harness.load_cell(name).limits
    assert harness.compare(got["program"], limits)[0]
    for role, readings in got.items():
        if role != "program":
            assert not harness.compare(readings, limits)[0], role


def test_tf32_is_the_control_precision():
    assert ref.TF32.dtype == torch.float32 and ref.TF32.tf32
    assert ref.FLOAT64.dtype == torch.float64 and not ref.FLOAT64.tf32


def loaded_tops(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in "
                          "sys.modules})))"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_loads_nothing_of_the_port_or_jax():
    tops = loaded_tops("import portbench.reference.gpvae")
    assert not tops & {"gpvae_tpu_torch", "gpvae_tpu", "jax", "jaxlib", "flax"}


def test_a_run_loads_no_jax_nor_the_jax_package():
    code = ("import sys, time, torch\n"
            "sys.path.insert(0, 'portbench/tests')\n"
            "from test_bench_runs import run\n"
            "for name in ('t1024_toeplitz.train.t8192', "
            "'bench_t100.impute.t1024'):\n"
            "    assert run(name)['correct']\n"
            "from portbench import harness\n"
            "assert harness.forbidden_modules() == []\n")
    tops = loaded_tops(code)
    assert "gpvae_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole(monkeypatch):
    assert "gpvae_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gpvae_tpu.models",
                        types.ModuleType("gpvae_tpu.models"))
    assert harness.forbidden_modules() == ["gpvae_tpu"]


def no_result(cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "bench_t100.impute.t1024", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    return out


def test_a_run_with_no_card_fails_and_prints_no_result():
    assert "no CUDA device" in no_result(ROOT).stderr


def test_a_run_without_the_port_beside_it_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert "gpvae_tpu_torch" in no_result(tmp_path).stderr


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "bench_t100.impute.t1024", "--seed", str(SEED), "--seconds", "2",
         "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=600, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
