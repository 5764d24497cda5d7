"""One reader per per-layer metric, in a file named after the metric.

Each module has `read(r)`, which takes the run's `Readings`
(vobench/run.py: the traced slice's summary, the steps traced, the
captured graph's kernel nodes, the host clock's per-frame step times, the
BA windows' refine times, the cell's configuration) and returns the
metric's value, or None where it finds nothing to read; the harness then
leaves the metric out of the result line.
"""
