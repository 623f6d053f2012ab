"""The benchmark of sph_tpu_torch on one NVIDIA card.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells, metrics and bounds are in BENCHMARK.json at the repository root.
Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name BENCHMARK.json gives it:
`configs/<config>.json`, `traffic/<traffic>.json`, `metrics/<metric>.py`.
A configuration names its input generator (`scenes/`) and its plain
reference (`reference/`); a traffic mix names the driver (`drivers/`) that
turns its parameters into calls of the program's public API.
"""
