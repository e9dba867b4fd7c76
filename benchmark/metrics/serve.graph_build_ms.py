"""serve.graph_build_ms: the host's time inside the calculator's
``Calculator.batch`` (neighbor list, collate, copy to the device; a
benchmark span), mean over the window's requests outside the
traced slice, in ms."""


def read(name, rec):
    d = rec['spans'].get('graph_build')
    return 1e3 * sum(d) / len(d) if d else None
