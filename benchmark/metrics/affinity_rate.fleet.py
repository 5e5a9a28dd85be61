"""Percent of the window's placements that the fleet's router sent to
the replica holding the request's prefix (reason ``affinity``), of all
its placements (affinity, load and spill): the window's difference of
`ServeFleet.fleet_stats()["routed"]`."""


def read(ctx):
    routed = ctx.layer.get("routed")
    total = sum(routed.values()) if routed else 0
    if not total:
        return None
    return 100.0 * routed.get("affinity", 0) / total
