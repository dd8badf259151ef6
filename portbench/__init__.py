"""The benchmark of `pathtracer_tpu_torch` on the card: `run.py` runs one
cell of `BENCHMARK.json`; `spec` finds a cell's files by name, `traffic`
makes its inputs from the seed, `drivers` drives the program, `check`
holds its outputs to the plain reference (`reference/`), `tracing` and
`metrics/` read the per-layer metrics, `roofline` holds the frozen bounds.
"""
