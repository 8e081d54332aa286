"""Per layer: milliseconds a step in the window of the host back half,
`decode_fetched` (unpack, deframe, dedup), from the engine's per-step
split."""


def read(run):
    st = run.stats
    return 1e3 * st["host_s"] / st["steps"] if st["steps"] else None
