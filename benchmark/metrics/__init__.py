"""The metrics, one module a metric, named as BENCHMARK.json names it. Each
has `read(ctx) -> float | None`: None where the run has nothing to read
(the metric is then left out of the result). The context (run.py
`metric_context`) holds, for the measured window:

  net        test squarings completed, net of Gerbicz-Li rollbacks
  window_s   its seconds (host clock); setup_s the seconds before it
  squarings  {"test": R0's, "replay": the checks' on R3, "all": every
             squaring the engine was asked for}
  calls      the port's kernel-wrapper calls (ops/kernels.calls) in it
  trace      tracing.summarize of the traced window, or None
  plan       the configuration's plan: R1, R2, C, T, n
  card       {"sms": SM count, "sm_clock_hz": clocks.max.sm} or None
"""
