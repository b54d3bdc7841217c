"""One reader per metric, found by the metric's name: ``read(run)`` returns
the value, or None where the run holds nothing to read (the harness then
leaves the metric out).  ``run`` carries the window's solves, set-up,
memory peak, the traced run's spans and trace summary, and the cell's
configuration (``hddbench/run.py``)."""
