"""The serving stack's telemetry registries, the port's own copies of the
jax-free halves of `tpu_dra.utils` that the engine writes and a scraper
reads: `metrics` (the series and the HTTP endpoint), `trace` (spans and
their ring) and `servestats` (the step flight recorder)."""
