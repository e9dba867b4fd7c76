"""gaunt_roofline: the Gaunt stage's byte floor over 3.35 TB/s
(``count/gaunt.py``: what any implementation must move for the traced
requests' live edges and nodes, the forward and, where its kernels were
found, the force backward) over the device time of the kernels launched
inside the program's ``gaunt.*`` spans and their backward, in %."""


def read(name, rec):
    g = (rec['trace'] or {}).get('gaunt')
    if not g or g['fwd_s'] + g['bwd_s'] <= 0:
        return None
    return 100.0 * g['floor_s'] / (g['fwd_s'] + g['bwd_s'])
