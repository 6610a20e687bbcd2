"""Traffic drivers, one module per kind, found by a cell's ``driver``.

Each exposes ``plan(run)`` (make the traffic from the seed, before the
build), ``warm(run)`` (the cell's own path, uncounted), ``window(run)``
(the measured window, and whatever must finish after it),
``checked(run)`` (the queries and answers that the reference judges) and
``control_queries(run)`` (the same queries for the control)."""
