"""gaunt.grid_gib: the program's counter ``gaunt.grid_bytes`` (the bytes
of the per-edge sample grids of each Gaunt convolution, E x mul x M^2
elements) over the traced slice's requests, in GiB a request."""


def read(name, rec):
    g = (rec['trace'] or {}).get('gaunt')
    n = rec['stats'].get('trace_units', 0)
    got = (g or {}).get('counters', {}).get('gaunt.grid_bytes')
    if not got or not n:
        return None
    return got / n / 2 ** 30
