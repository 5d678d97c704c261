"""Benchmark of the PyTorch/CUDA port of CerberusDet (cerberusdet_tpu_torch).

Run one cell once: python -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>, from the root of a checkout. BENCHMARK.json
names the cells; every configuration, traffic mix, per-cell limit and metric
is a file of its own under this folder, found by its name.
"""
