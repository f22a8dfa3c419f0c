"""The benchmark of strawberry_tpu_torch: one command, data-driven cells.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the root of the checkout names the cells; each cell's
configuration, traffic mix and per-layer metrics are files of their own under
`portbench/{configs,traffic,metrics}/`, found by their names.
"""
