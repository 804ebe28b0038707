"""The benchmark of color_neus_torch: one cell a run.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

BENCHMARK.json at the root names the cells, configurations and metrics;
each lives in files of its own under this folder (spec.py finds them).
"""
