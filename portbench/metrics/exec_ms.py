"""Per layer: milliseconds a step in the window from `dispatch_wire`
(the device program's launches) to its device result, the wait
included (the engine's per-step split)."""


def read(run):
    st = run.stats
    return 1e3 * st["exec_s"] / st["steps"] if st["steps"] else None
