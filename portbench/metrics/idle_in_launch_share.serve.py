"""Share of the card's idle time in the traced window during which the
host was inside a launch span of the program (``prefill.launch``,
``decode.launch``, ``spec.launch``): idle while the host is still issuing
the work. The spans are placed on the profiler's clock by the harness's
own offset (``Trace.ns``). Nothing is read from a program without the
tracer, or a run that recorded no spans.

The launch spans cover most of a serving window (the whole forward pass
of a prefill or a decode tick, host preparation included), so read this
share beside their share of the window's wall time (``launch_share`` of
``tools/span_report.py``): where the two are near, it says that the host
is inside the model's forward code while the card idles, not what costs
the time there (Python, dispatch or launch latency)."""


def read(run):
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    s, tr = telemetry.last(), run.trace
    if s is None or tr.busy_s is None:
        return None
    launch = sorted((tr.ns(x.t0), tr.ns(x.t1)) for x in s.spans
                    if x.name.endswith(".launch") and x.t1 is not None
                    and tr.pc0 <= x.t1 <= tr.pc1)
    if not launch:
        return None
    edges = [tr.ns0] + [e for ab in tr.merged for e in ab] + [tr.ns1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    total = sum(b - a for a, b in idle)
    inside, j = 0, 0
    for a, b in idle:
        while j < len(launch) and launch[j][1] <= a:
            j += 1
        k = j
        while k < len(launch) and launch[k][0] < b:
            inside += max(0, min(b, launch[k][1]) - max(a, launch[k][0]))
            k += 1
    return 100.0 * inside / total if total else None
