"""Percent of the window's admitted prompt tokens that the replicas'
prefix caches served (aliased blocks) instead of prefilling: the
window's difference of the replicas' ``prefix_stats``
(``prefill_tokens_reused`` over it plus ``prefill_tokens_computed``)."""


def read(ctx):
    reuse = ctx.layer.get("reuse")
    total = (reuse["reused"] + reuse["computed"]) if reuse else 0
    if not total:
        return None
    return 100.0 * reuse["reused"] / total
