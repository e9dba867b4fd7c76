"""kernels_roofline.<group>: the csrc kernels' summed memory bound (each
launch's bytes over 3.35 TB/s, ``count/bounds.py``, from the census of the
traced slice) over their summed device time in the slice, in %."""


def read(name, rec):
    tr, bounds = rec['trace'], rec['bounds']
    if tr is None or not bounds:
        return None
    dev = sum(s for fam, (c, s) in tr['csrc'].items() if fam in bounds)
    if dev <= 0:
        return None
    return 100.0 * sum(bounds[fam] for fam in tr['csrc'] if fam in bounds) \
        / dev
