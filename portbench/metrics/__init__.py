"""Metric readers: ``<metric>.py`` holds ``read(record) -> float | None``
(``harness.Record``); ``None`` leaves the metric out of the line."""
