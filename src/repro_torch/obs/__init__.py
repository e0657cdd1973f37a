"""Decode telemetry containers (copy of ``repro.obs.telemetry``'s records)."""
