"""Observability (L3): per-GPU telemetry samples."""
