"""Per-layer metric readers, one file per metric, named as the metric.

Each module declares ``LAYER``, ``UNIT``, ``BETTER`` and ``MOVES`` (as
``BENCHMARK.json`` lists them) and ``read(ctx)``, which returns the
metric's value from the traced run or None where it finds nothing to
read (the harness then leaves the metric out). ``ctx`` carries the trace
summary (``ctx.trace``), the traced window's seconds (``ctx.window_s``),
the driver's counts of the work done in it (``ctx.work``), the harness's
own host spans (``ctx.spans``: name -> seconds of each), the calls
recorded for metrics that declare ``RECORD`` (``ctx.calls``) and the
cell's configuration (``ctx.config``). A module with ``RECORD = (module,
function)`` and ``shape(*args, **kwargs)`` has the harness record the
shapes of that function's calls during the window.
"""
