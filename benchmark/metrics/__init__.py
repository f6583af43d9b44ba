"""One reader per per-layer metric, found by the metric's name: each
module's ``read(summary)`` takes the window's ``tracing.Summary`` and
returns the metric's value, or None where the traces hold nothing for
it (the harness then leaves the metric out of the result line)."""
