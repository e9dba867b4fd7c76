"""mfu.<group>: the model's floating-point work (``count/flops.py``:
forward passes at the live edges and nodes, a force evaluation 3 and a
train step 9 of them) over 67 TFLOP/s float32 x the seconds x the chips,
in %: over the part of the window after the traced slice (the profiler
slows the host), else over the whole window."""

from benchmark.count.bounds import FP32_FLOP_PER_S


def read(name, rec):
    st = rec['stats']
    if st.get('flops_untraced'):
        flops, secs = st['flops_untraced'], st['seconds_untraced']
    else:
        flops, secs = st.get('flops'), rec['window_s']
    if not flops:
        return None
    return 100.0 * flops / (FP32_FLOP_PER_S * secs * rec['chips'])
