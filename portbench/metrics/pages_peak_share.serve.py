"""Peak share of the page pool in use (pages held by a slot or kept in the
prefix cache), read from the engine's paging after each step of the
window, over the pool's usable pages. Under 100% the pool never bound:
no request waited or was preempted for pages."""


def read(run):
    usable = run.counters.get("pages_usable")
    if not usable:
        return None
    return 100.0 * run.counters["pages_peak"] / usable
