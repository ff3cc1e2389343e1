"""The benchmark of prmers_tpu_torch: Gerbicz-Li-checked PRP tests through
the port's own PRP driver (modes/prp_ll.run_prp_or_ll) on one card.

One command runs one cell once, from the root of a checkout:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

and prints one JSON line last on standard output. The harness is driven
by data, each piece found by the name BENCHMARK.json gives it:

  configs/<name>.json   a deployment: the exponent band a seed draws its
                        exponent from, and the plan the band takes
  traffic/<name>.json   a traffic mix: the CLI options the PRP run gets
                        and, where a window's schedule needs it, the
                        share of B the exponent's first Gerbicz-Li block
                        takes
  metrics/<name>.py     a per-layer metric: read(ctx) -> float or None

The yardstick lives here too and imports nothing of the port: the plain
reference (reference.py: a float64 IBDWT squaring chain in torch), the
comparison that decides `correct` (judge.py), the reading of the
profiler's trace (tracing.py) and the peaks and work counts of the
roofline (yardstick.py). The port gives only the system under test, its
counters (ops/kernels.calls) and its kernel names.

CPU tests: `python -m pytest benchmark/tests -q` (the gpu-marked ones
skip without a card; on the card `python -m pytest benchmark/tests -m gpu
-q`). The control readings: `python3 -m benchmark.control --workload
<cell> --seeds a,b,c`.
"""
