"""Per-layer metric readers.  The reader of a metric is
``metrics/<name>.py``, or, where there is none, ``metrics/<name up to its
first dot>.py``, which serves every cell's share of one quantity
(``mfu.train``, and a later kind of cell's ``mfu.<kind>``).  Each defines ``read(ctx, rec)``, which
returns the metric or None where the run holds nothing to read."""
