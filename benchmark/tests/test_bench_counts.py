"""The FLOP counter and the kernels' byte bounds against counts worked by
hand on a tiny layout."""

import pytest

TINY_CFG = {'_number_of_species': 1, '_type_map': {8: 0}, 'channel': 2,
            'lmax': 1, 'num_convolution_layer': 1, 'cutoff': 4.0,
            'self_connection_type': 'linear', 'interaction_type': 'nequip',
            'is_parity': True}


def test_flops_of_a_one_layer_scalar_model():
    from benchmark.count.flops import FlopCounter

    f = FlopCounter(TINY_CFG)
    # one layer restricted to scalars: the only path is 2x0e x 0e -> 0e
    # (nnz 1): sh x C 2, then 2 channels x (2 nnz + 2 d_out) = 8; the
    # radial MLP 8 -> 64 -> 64 -> 2: 2 (512 + 4096 + 128)
    assert f.per_edge == 2 + 8 + 2 * (8 * 64 + 64 * 64 + 64 * 2)
    # embedding 1 -> 2 (4), self-connection, si1, si2 2 -> 2 (8 each),
    # the gate over 2 scalars (6), readout 2 -> 1 (4) and 1 -> 1 (2)
    assert f.per_node == 4 + 8 + 8 + 8 + 6 + 4 + 2
    assert f.forward(10, 3) == 10 * f.per_edge + 3 * f.per_node


def test_passes_follow_the_backward_costs_twice_convention():
    from benchmark.count.flops import FORCE_PASSES, TRAIN_PASSES

    assert FORCE_PASSES == 1 + 2
    assert TRAIN_PASSES == 3 * FORCE_PASSES


def test_kernel_bytes_by_hand():
    from benchmark.count import bounds as B

    # msg [10, 3] with 6 live rows, dst [10], out [4, 3]
    assert B.segment_sum_bytes(10, 3, 4, 6) == 4 * 18 + 4 * 10 + 4 * 12
    # x, sh, w of widths 5, 9, 2 on 6 live edges; out [4, 7]
    assert B.agg_bytes(10, 6, 4, 5, 9, 2, 7) == 4 * 6 * 16 + 40 + 4 * 28
    assert B.gagg_bytes(10, 6, 4, [5, 9], 7) == 4 * 6 * 14 + 40 + 4 * 28
    # ybar [4, 7], legs 5 and 2 live, outputs of widths 9 and 5 on all 10
    assert B.gmulti_bytes(10, 6, 4, [5, 2], [9, 5], 7) == \
        4 * 28 + 4 * 6 * 7 + 40 + 4 * 10 * 14
    assert B.bound_s(3.35e12) == pytest.approx(1.0)


def test_census_reads_live_edges_after_the_slice():
    import torch

    from benchmark.count.bounds import Census, bound_s, segment_sum_bytes

    c = Census()
    dst = torch.tensor([0, 0, 1, 3, 4, 4])       # 4 rows: two sentinels
    c.records.append(('segment_sum', dict(E=6, D=2, n_rows=4), dst))
    got = c.bound_seconds()
    assert got['segment_sum'] == pytest.approx(
        bound_s(segment_sum_bytes(6, 2, 4, 4)))
