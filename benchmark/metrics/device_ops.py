"""device_ops.<group>: device kernels in the traced slice over the steps or
requests in it (the program's dispatch count a unit of work)."""


def read(name, rec):
    tr, n = rec['trace'], rec['stats'].get('trace_units', 0)
    if tr is None or not n:
        return None
    return tr['n_device_ops'] / n
