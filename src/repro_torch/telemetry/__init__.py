"""Telemetry — scope-tagged span traces and the metrics registry."""
