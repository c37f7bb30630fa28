"""The benchmark of ``gpvae_tpu_torch``, the PyTorch and CUDA port, on one
NVIDIA H100: ``python portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``.  See ``BENCHMARK.json`` and PERF.md."""
