"""Per layer: milliseconds a step in the window spent in `stage_wire`,
the wire's pageable copy to the card (the engine's per-step split)."""


def read(run):
    st = run.stats
    return 1e3 * st["stage_s"] / st["steps"] if st["steps"] else None
