"""eqv2.device_share: the share of the traced slice's device time in the
kernels, copies and fills launched inside the program's ``eqv2.*`` spans
(the edge embedding, each block's attention and FFN, the head) and inside
the backward of the ops recorded in them (``program_spans.
launched_within``), in %."""


def read(name, rec):
    g = (rec['trace'] or {}).get('eqv2')
    if not g or g['all_s'] <= 0:
        return None
    return 100.0 * (g['fwd_s'] + g['bwd_s']) / g['all_s']
