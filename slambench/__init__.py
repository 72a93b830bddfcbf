"""slambench: the benchmark of lmono_tpu_torch on one NVIDIA H100.

    python3 -m slambench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of `BENCHMARK.json` once and prints its result as the last
line of standard output.  See `harness.py` for what a run does and
`reference.py` for how `correct` is decided.
"""
