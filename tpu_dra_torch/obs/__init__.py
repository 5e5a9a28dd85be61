"""The engine-side documents of the observability plane, the port's own
copies of `tpu_dra.obs`'s registries that a serving engine feeds: `kv`
(``/debug/kv``), `requests` (``/debug/requests``) and the engines' half of
`capacity` (``/debug/capacity``)."""
