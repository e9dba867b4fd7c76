"""halo.bytes_per_step: the program's counter ``halo.swap_bytes`` (the
bytes each rank sends in its swaps, forward and backward) summed over the
ranks and the window, over the window's MD steps."""


def read(name, rec):
    got = rec['stats'].get('halo_swap_bytes')
    n = rec['stats'].get('units', 0)
    if not got or not n:
        return None
    return got / n
