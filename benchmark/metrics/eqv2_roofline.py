"""eqv2_roofline: the EquiformerV2 stage's floor (``count/eqv2.py``: each
part's larger of its FLOPs over 67 TFLOP/s float32 and its bytes over
3.35 TB/s, summed, for the traced requests' capped edges and nodes, the
forward and, where its kernels were found, the force backward) over the
device time of the kernels launched inside the program's ``eqv2.*`` spans
and their backward, in %."""


def read(name, rec):
    g = (rec['trace'] or {}).get('eqv2')
    if not g or g['fwd_s'] + g['bwd_s'] <= 0:
        return None
    return 100.0 * g['floor_s'] / (g['fwd_s'] + g['bwd_s'])
