"""The plain reference against the port, both in float64 on the CPU at
T=16, for both configurations and both traffic kinds: the same weights,
batches and noise give the same losses, gradients, Adam updates and
imputations."""
from __future__ import annotations

import pytest
import torch

from portbench import harness, inputs
from portbench.reference import gpvae as ref

CPU = torch.device("cpu")
T = 16


def setup(cell_name: str, **mix):
    from gpvae_tpu_torch.models import GPVAE

    cell = harness.load_cell(cell_name)
    cell.mix.update(time_len=T, xmax=15.0 if "8192" in cell_name else 60.0,
                    **mix)
    mc, preset = harness.model_config(cell)
    weights = inputs.weights(cell.config, 5, CPU)
    model = GPVAE(mc).double()
    model.load_state_dict(weights)
    return cell, preset, weights, model


def data(cell, n: int) -> dict:
    d = inputs.toy_sequences(inputs.generator(7, CPU, 2), n, T,
                             xmax=cell.mix["xmax"],
                             hide_fraction=cell.mix["hide_fraction"],
                             obs_dim=cell.config["model"]["obs_dim"])
    return d


@pytest.mark.parametrize("cell_name", ["bench_t100.train.t1024",
                                       "t1024_toeplitz.train.t8192"])
def test_reference_trains_as_the_port(cell_name):
    from gpvae_tpu_torch import train as train_lib

    cell, preset, weights, model = setup(cell_name)
    b, z = cell.config["batch_size"], cell.config["model"]["latent_dim"]
    d = data(cell, 3 * b)
    batches = [{k: v[s * b:(s + 1) * b] for k, v in d.items()}
               for s in range(3)]
    g = torch.Generator().manual_seed(3)
    noise = [torch.randn((1, b, z, T), generator=g, dtype=torch.float64)
             for _ in batches]
    state = train_lib.create_train_state(
        model, train_lib.TrainConfig(learning_rate=cell.config["learning_rate"]),
        CPU)
    losses, grad1 = [], None
    for s, (batch, eps) in enumerate(zip(batches, noise)):
        b64 = {k: (v.double() if v.is_floating_point() else v)
               for k, v in batch.items()}
        out = train_lib.train_step(state, b64, preset.train.beta(s), eps=eps)
        losses.append(float(out["loss"]))
        if grad1 is None:
            grad1 = {n: p.grad.clone() for n, p in model.named_parameters()}
    want = ref.train(cell.config, weights, batches, noise, ref.FLOAT64)
    assert losses == pytest.approx(want["loss"], rel=1e-12)
    assert set(want["params"]) == set(grad1)
    for n, p in model.named_parameters():
        torch.testing.assert_close(grad1[n], want["grad1"][n], rtol=1e-9,
                                   atol=1e-13)
        torch.testing.assert_close(p.detach(), want["params"][n], rtol=1e-10,
                                   atol=1e-13)


@pytest.mark.parametrize("cell_name,seqs", [("bench_t100.impute.t1024", 4),
                                            ("t1024_toeplitz.impute.t8192", 1)])
def test_reference_imputes_as_the_port(cell_name, seqs):
    from gpvae_tpu_torch import analysis

    cell, _, weights, model = setup(cell_name)
    d = data(cell, seqs)
    kept = inputs.dropped(inputs.generator(7, CPU, 4), d["mask"], 0.5)
    probs, zi, _ = analysis.impute(model, d["x"].double(), d["times"].double(),
                                   d["mask"], kept)
    # the port adds the jitter of its dtype: 1e-6 in float64 (the measured
    # float32 runs add the configuration's 1e-5)
    cfg = dict(cell.config, impute_jitter=1e-6)
    want = ref.impute(cfg, weights, d, kept, ref.FLOAT64)
    # the port solves L^-1 [K_oq, z], the reference (L L^T)^-1 z: equal in
    # exact arithmetic
    torch.testing.assert_close(zi, want["z"], rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(probs, want["probs"], rtol=1e-10, atol=1e-12)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -12)], dtype=torch.float32)
    assert ref.round_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0,
                                          1.0 + 2 ** -9, -1.0]
    a = torch.randn(5, 7, dtype=torch.float32, requires_grad=True)
    b = torch.randn(7, 3, dtype=torch.float32, requires_grad=True)
    out = ref.mm(a, b, ref.TF32)
    torch.testing.assert_close(out, a @ b, rtol=3e-3, atol=3e-3)
    out.sum().backward()
    assert a.grad is not None and b.grad is not None
