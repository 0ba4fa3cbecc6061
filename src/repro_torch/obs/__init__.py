"""Observability for the port: only ``metrics.WindowedCounter`` so far,
which the tiered pool's hit-rate counters use. The rest of the
reference's ``obs/`` (the registry, spans, exporters) is ROADMAP.md
queue 1 item 11."""
