"""eqv2.attn_share: of the device time that ``eqv2.device_share`` counts,
the share launched inside the program's ``eqv2.attn`` spans (each block's
graph attention: the rotations, the SO(2) convolutions, the S2
activation, the softmax and the sums at the destinations) and their
backward, in %."""


def read(name, rec):
    g = (rec['trace'] or {}).get('eqv2')
    if not g or g['fwd_s'] + g['bwd_s'] <= 0:
        return None
    return 100.0 * g['attn_s'] / (g['fwd_s'] + g['bwd_s'])
