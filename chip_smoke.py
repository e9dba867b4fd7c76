#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``sevennet_finetuning_tpu_torch`` (never JAX) through twelve
phases and exits non-zero if any fails:

1. build   -- compile every CUDA source of ``csrc/`` (one nvcc each, in
              parallel) and print the build time;
2. probes  -- the seven measurement kernels of ``tools`` (the copy
              bandwidth probe and the Hopper feature probes) at the TPU
              tools' shapes on numpy-seeded inputs (seed 0), each held
              against its plain version (bit for bit; the column sum
              within 2e-6 x the column's sum of |x| and the same bits in
              two launches, the wgmma product within 2e-6 x max|plain|;
              the four feature probes the same bits in two launches,
              the window at selectors 0, 5 and 11 and zeros at 12, the
              transpose at [36, 20] and the split at 4,100 elements)
              and timed with its library call (CUDA events and profiler
              device us a call, each beside the library call's; the
              feature probes also beside the floor, the device time of
              ``bench_dma``'s overhead control, printed first); the
              tiled copy at every em / fm tile of the TPU sweep and the
              ring at every shape of ``bench_dma.ring_variants``, each
              case beside ``torch.mul`` and each row's worst factor;
              then both tools' ``main()`` as a user runs them, with the
              launch counts set to 0 before: the feature probes' OK lines
              and the bench sweep's GB/s table with the card line;
3. kernels -- call each kernel's wrapper at main-path shapes (a batch-8
              collate of ft900.extxyz; the conv layouts of blocks 0, 1
              and 4 of SevenNet-0; segment sums at D = 1, 6 and 480 over
              the 768 nodes and at each distinct shape a train step
              launches, the per-graph energy and virial among them; the
              double backward's gagg of 3 terms, and of 1 term (cg_agg's
              function: its yardstick, timed and its bits compared beside
              cg_agg), and gmulti of 6 jobs in 3
              groups, and without its sh group; cg_multi (cg_gmulti.cu
              built for one slot) with the block's jobs, with one job
              each of xn, shn, wn, and with xn + wn; the per-edge cg_quad
              in each mode msg / x / sh / w, with its profiler device us a
              call) and hold it against
              its plain PyTorch version:
              max|kernel - plain| <= 2e-6 * max|plain| (segment_sum:
              bit for bit against the plain version on the host CPU, which
              adds in edge order, as the kernel does); segment_sum,
              cg_agg, cg_multi, cg_gagg, cg_gmulti and cg_quad must give
              the same bits in two launches at every timed shape.  Times
              come from CUDA events after warm-up; the bound is the larger
              of bytes over 3.35 TB/s and fp32 operations over 67 TFLOP/s
              (H100 SXM data sheet), counted at the live edges;
4. serve   -- ``Calculator.from_checkpoint`` on the in-repo SevenNet-0
              checkpoint answers each structure of ft.extxyz; results are
              held against the committed JAX-CPU golden file (energy rel
              <= 2e-6, forces and stress max-abs rel <= 1e-4) and every
              request must launch agg 5, multi 5 and segment-sum >= 8
              times;
5. batch   -- ``apply_model`` on one batch-8 collate of ft900.extxyz:
              ms per batch and edges/s;
6. profile -- torch.profiler over one request and one batch-8 forward:
              device busy share and device time by kernel, the launches of
              each csrc kernel family summed into one row, whose count
              must equal the launches its wrapper counted in that run;
7. train   -- the reEWC fine-tune ``Trainer`` on SevenNet-0 at full width
              and depth (recipe of experiments/ft_reewc_900, constant LR
              1e-4): 2 steps on the 12-atom structure of ft.extxyz against
              ``golden/train_ft12_jax_cpu.npz`` (loss terms and every
              leaf's first-step gradient), then 3 rehearsal iterations at
              batch 8 against ``golden/train_ft900_jax_cpu.npz`` (per-step
              loss terms, every leaf's first-step gradient and the
              rehearsal epoch's metrics); every train
              step must launch agg 5, multi 10, gagg 5, gmulti 5 and
              segment-sum 13 times, the segment sums at the shapes of
              ``train_segment_shapes``.  Prints ms per step and per rehearsal
              iteration, edges/s, peak memory and the device busy share;
8. pipeline -- the port's train CLI (``main.main``, as ``python -m
              sevennet_finetuning_tpu_torch.main train`` runs it) on the
              two stages of ``recipe.pipeline_stages`` in a temporary
              directory: the Fisher stage (-fs) on replay.extxyz from the
              in-repo SevenNet-0 checkpoint, then a 3-epoch reEWC
              fine-tune on ft.extxyz with rehearsal on replay.extxyz
              consuming its artifacts.  Held against
              ``golden/pipeline_ft_jax_cpu.npz``: the anchor bit for bit,
              each Fisher leaf within 2e-3 of its max (4e-2 for the energy
              shift), log.csv value by value (the first step's within
              1e-4, later ones within 5e-2, each plus the serving limit
              of its quantity), the same checkpoint files, and
              checkpoint_best.pth served through
              ``Calculator.from_checkpoint``; the two stages must launch
              agg 65, multi 115, gagg 50, gmulti 50 and segment-sum
              >= 130 times.  Prints each stage's wall seconds and the
              epochs' times, then profiles each stage once more;
9. unsorted -- SevenNet-0 at full width and depth on the batch-8 collate
              with every edge slot permuted (numpy seed 0), through the
              public ``run_blocks(edges_sorted=False)``: node features,
              energies, fij = dE/d edge_vec and a create_graph=True
              parameter gradient of a fixed random-weighted loss on fij.
              Held against ``golden/unsorted_ft900_jax_cpu.npz`` (energy
              rel <= 2e-6, fij max-abs rel <= 1e-4) and against the sorted
              path on the same graph (features <= 1e-5 x max, fij <= 1e-4
              x max, every leaf's gradient <= 1e-3 x max|g|, the
              convolution denominators' 2e-3); one pass must
              launch cg_quad msg 19 / x 20 / sh 19 / w 19, segment-sum 20
              and none of agg, multi, gagg, gmulti.  Prints ms per forward
              plus fij, sorted and unsorted, and peak memory; profiles one
              forward + fij and one whole pass (the census's: forward, fij
              with create_graph, parameter gradient), each csrc family's
              profiled launches equal to its census.
10. md     -- molecular dynamics at SevenNet-0's full width, on the native
              neighbor list (the earlier phases keep the cKDTree one their
              goldens were made with): ``main get_model`` deploys the
              checkpoint to the npz artifact, ``Calculator.from_deployed``
              and ``main inference`` serve ft.extxyz from it (the serving
              golden's limits); ``Calculator(d3=pbe/bj)``'s D3 terms and
              totals against ``golden/md_hfo2_jax_cpu.npz`` (D3 energy rel
              1e-5, forces and stress 1e-4 of max; totals at the serving
              limits); ``VelocityVerlet.run_device`` on structure 0 of
              ft900.extxyz (96-atom HfO2, 500 K, seed 0, dt 2 fs, skin
              0.5 A, segments of 10): 20 steps, and 10 with D3, against
              the golden (the same steps per segment, E_pot each step rel
              1e-5, positions 1e-4 A, E_kin rel 1e-4, velocities 1e-6 +
              1e-3 |v|); ``run`` against ``run_device``
              from the same start (10 steps, the same limits) and with D3
              against the golden; the 2x2x2 replicate (768 atoms): E_pot
              8x the cell's (rel 1e-5), the replicas' forces (1e-4 of
              max), 20 device-loop steps under the NVE drift bound 5e-4
              eV/atom; the FCTP self-connection (EXAMPLE_MD_MODEL,
              init_params(spec, 0)) served on the card against the same
              model on the CPU and 5 device-loop steps.  Each force
              evaluation must launch agg 5 (FCTP 4), multi 5 (4) and
              segment-sum >= 8 (FCTP 7; 5 more with D3); ``segment_sum``,
              ``cg_agg`` and ``cg_multi`` are held against their plain
              versions at every distinct shape the phase launches them
              (requests, D3 terms, MD steps at 96 and 768 atoms with and
              without D3, the FCTP model's 4-channel chunks).  Prints ms
              per step and steps/s of ``run_device`` and ``run`` at 96 and
              768 atoms with and without D3, the steps per segment, peak
              memory and, from a profile of a 10-step run, the device busy
              share.
11. families -- the MACE and Gaunt interaction families at full width,
              the three configurations of ``golden/families_jax_cpu.npz``
              (the repo's mace interaction at MACE-MP-0 medium's widths,
              l <= 3 filter and 128 channels up to l = 3; gaunt and
              gaunt_gate at SevenNet-0's widths) with weights from
              init_params(spec, 0): a ``Calculator`` per family serves
              ft.extxyz against the golden (the serving limits; Gaunt's
              energy within 3e-5, its float32 floor: PERF.md), each
              request launching exactly its census (MACE agg 2, multi 2,
              segment-sum 5; Gaunt 1 / 1 / 8; Gaunt-gate 2 / 2 / 11); MACE
              and Gaunt take three train steps on ft900 structure 0
              against the golden (loss terms, every leaf's first-step
              gradient within 1e-3 of its max|g|), each step launching
              its census (MACE agg 2, multi 4, gagg 2, gmulti 2,
              segment-sum 7; Gaunt 1 / 2 / 1 / 1 / 13).  Every distinct
              shape of segment_sum, cg_agg, cg_multi, cg_gagg and
              cg_gmulti launched is held against its plain version, and
              the new shapes (MACE's l = 3 layouts; segment_sum at D =
              1,152 and 10,368) are timed beside their bounds.  Prints
              each family's parameter count, ms per request (wall and
              profiled device time), ms per train step and peak memory.
12. compat  -- checkpoint and deploy interop at SevenNet-0's full width
              (the card's name and power limit printed first): (1) the
              checkpoint as a reference training .pth (state_dict_from_
              params, the reference's trainer.py layout) through
              ``Calculator.from_checkpoint``: every parameter bit-equal,
              the five requests at the serving limits with the serve
              census; (2) ``main get_model --torchscript``: the artifact
              loaded on the card and fed pair_e3gnn's input dict, each
              structure at the serving limits against the golden and
              against the Calculator, atomic energies summing to the
              total, its metadata (89 symbols, cutoff 5.0, model_type),
              and ``_config_from_frozen`` / ``_extract_weight_ops`` on the
              graph the card's torch froze equal to the CPU's reading
              (``TS_FROZEN_CONFIG``, ``TS_WEIGHT_OP_SHAPES``); (3) ``-p``:
              five segments with comm_size of the spec, chained in one
              domain over structure 0 (forces from the accumulated dE/dr)
              within 6.4e-6 eV/atom and 1.9e-4 eV/A of the golden (ten
              times the CPU reading); (4) ``main graph_build`` of ft.extxyz
              and an artifact built with the checkpoint's type map, each
              the data of the pipeline phase's reEWC stage: log.csv within
              1e-6 relative of that phase's, the stage's census, rebuilt
              (graph_build's own species) or reused (the checkpoint's
              type map); (5) the checkpoint continued with its own adam
              state, two batch-8 steps at LR 1e-4, against
              ``golden/continue_ft900_jax_cpu.npz`` (the train phase's
              limits; every leaf's first update printed beside the
              golden's), and from a reset optimizer, which must miss the
              second step's limit.  The phase's launches are asserted
              (agg 135, multi 215, gagg 80, gmulti 80, segment-sum >= 248).

Before the last line it prints the card's name and power limit and a
JSON line with every kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --f64-reference

builds the kernels and then only takes the train phase's first six batch-8
steps twice, in float32 on the card and in float64 on the host CPU, and
prints how far the card's and the JAX-CPU golden's loss trajectories and
first-step gradients lie from the float64 ones (several minutes of CPU).
"""

import contextlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = ROOT / 'sevennet_finetuning_tpu_torch'
CKPT = ROOT / 'experiments/ft_reewc_900/conv_out/checkpoint_best.pth'
FT = ROOT / 'experiments/ft_reewc/data/ft.extxyz'
FT900 = ROOT / 'experiments/ft_reewc_900/data/ft900.extxyz'
GOLDEN = PKG / 'golden/ft_extxyz_jax_cpu.npz'
GOLDEN_FT12 = PKG / 'golden/train_ft12_jax_cpu.npz'
GOLDEN_FT900 = PKG / 'golden/train_ft900_jax_cpu.npz'
GOLDEN_UNSORTED = PKG / 'golden/unsorted_ft900_jax_cpu.npz'
GOLDEN_PIPELINE = PKG / 'golden/pipeline_ft_jax_cpu.npz'
REPLAY900 = ROOT / 'experiments/ft_reewc_900/data/replay900.extxyz'
REPLAY = ROOT / 'experiments/ft_reewc/data/replay.extxyz'
FISHER = ROOT / 'experiments/ft_reewc/fisher_out/fisher_sevenn.pt'
OPT_PARAMS = ROOT / 'experiments/ft_reewc/fisher_out/opt_params_sevenn.pt'

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12        # H100 SXM data sheet, non-tensor fp32
BF16_TC_FLOP_PER_S = 989e12    # H100 SXM data sheet, dense bf16 tensor core
KERNEL_TOL = 2e-6
BATCH = 8
PROBE_IT = 50                  # timed launches of each probe kernel

SOURCES = {
    'segment_sum': dict(
        source='sevennet_finetuning_tpu_torch/csrc/segment_sum.cu',
        replaces='sevennet_finetuning_tpu/ops/pallas_scatter.py:512'),
    'cg_agg': dict(
        source='sevennet_finetuning_tpu_torch/csrc/cg_agg.cu',
        replaces='sevennet_finetuning_tpu/ops/fused_conv_agg_kernel.py:194'),
    # the first-order backward: cg_gmulti.cu's kernel built for one slot
    'cg_multi': dict(
        source='sevennet_finetuning_tpu_torch/csrc/cg_gmulti.cu',
        replaces='sevennet_finetuning_tpu/ops/fused_conv_bwd_kernel.py:478'),
    'cg_gagg': dict(
        source='sevennet_finetuning_tpu_torch/csrc/cg_gagg.cu',
        replaces='sevennet_finetuning_tpu/ops/fused_conv_agg_kernel.py:330'),
    'cg_gmulti': dict(
        source='sevennet_finetuning_tpu_torch/csrc/cg_gmulti.cu',
        replaces='sevennet_finetuning_tpu/ops/fused_conv_bwd_kernel.py:650'),
    'cg_quad': dict(
        source='sevennet_finetuning_tpu_torch/csrc/cg_quad.cu',
        replaces='sevennet_finetuning_tpu/ops/fused_conv_kernel.py:167'),
}
PROBE_COPY = 'sevennet_finetuning_tpu_torch/csrc/probe_copy.cu'
PROBE_FEATS = 'sevennet_finetuning_tpu_torch/csrc/probe_feats.cu'
SOURCES.update({
    'probe_copy_tiled': dict(source=PROBE_COPY,
                             replaces='tools/bench_dma.py:84'),
    'probe_colsum': dict(source=PROBE_COPY, replaces='tools/bench_dma.py:109'),
    'probe_copy_ring': dict(source=PROBE_COPY,
                            replaces='tools/bench_dma.py:167'),
    'probe_transpose': dict(source=PROBE_FEATS,
                            replaces='tools/test_mosaic_feats.py:47'),
    'probe_split': dict(source=PROBE_FEATS,
                        replaces='tools/test_mosaic_feats.py:74'),
    'probe_dot': dict(source=PROBE_FEATS,
                      replaces='tools/test_mosaic_feats.py:96'),
    'probe_window': dict(source=PROBE_FEATS,
                         replaces='tools/test_mosaic_feats.py:123'),
})
PROBES = tuple(k for k in SOURCES if k.startswith('probe_'))
# the case of a probe row that the kernels line reports (its table case)
PROBE_CASE = {'probe_copy_tiled': 'em te=256',
              'probe_copy_ring': 'rows=8 slots=4 split=2'}
# the kernels each path must launch (the others it must not)
PATH_KERNELS = {
    'serve': ('segment_sum', 'cg_agg', 'cg_multi'),
    'train': ('segment_sum', 'cg_agg', 'cg_multi', 'cg_gagg', 'cg_gmulti'),
    'pipeline': ('segment_sum', 'cg_agg', 'cg_multi', 'cg_gagg',
                 'cg_gmulti'),
    'unsorted': ('segment_sum', 'cg_quad'),
    'probes': PROBES,
    'md': ('segment_sum', 'cg_agg', 'cg_multi'),
    'families': ('segment_sum', 'cg_agg', 'cg_multi', 'cg_gagg',
                 'cg_gmulti'),
    'compat': ('segment_sum', 'cg_agg', 'cg_multi', 'cg_gagg', 'cg_gmulti'),
}
# the path whose count a kernel's "launches" reports: the train step for
# the kernels of the sorted convolution, the unsorted pass for cg_quad
KERNEL_PATH = {name: 'train' for name in SOURCES}
KERNEL_PATH['cg_quad'] = 'unsorted'
KERNEL_PATH.update({name: 'probes' for name in PROBES})
# the model kernels' family of a device kernel's name (the first match):
# the entry point whose launches run it, so the instances of a template
# add up to one profile row (the profiled paths launch no probe)
KERNEL_FAMILIES = (
    ('seg_sum_', 'segment_sum'), ('cg_agg_bulk_kernel', 'cg_agg'),
    ('cg_gagg_kernel', 'cg_gagg'), ('cg_gmulti_kernel<1>', 'cg_multi'),
    ('cg_gmulti_kernel<2>', 'cg_gmulti'), ('cg_quad_kernel', 'cg_quad'))
# launches of one reEWC train step (PERF.md explains each count)
TRAIN_CENSUS = {'cg_agg': 5, 'cg_multi': 10, 'cg_gagg': 5, 'cg_gmulti': 5,
                'segment_sum': 13, 'cg_quad': 0, **{k: 0 for k in PROBES}}
# launches of one unsorted pass: forward, fij with create_graph=True, and
# the parameter gradient of a loss on fij (PERF.md explains each count)
UNSORTED_CENSUS = {'cg_agg': 0, 'cg_multi': 0, 'cg_gagg': 0, 'cg_gmulti': 0,
                   'segment_sum': 20, 'cg_quad': 77, **{k: 0 for k in PROBES}}
UNSORTED_MODES = {'msg': 19, 'x': 20, 'sh': 19, 'w': 19}
# unsorted against sorted on the same graph: only the order of float32
# sums differs (the per-edge messages are summed after a sort by dst, the
# fused kernels sum them per node)
UNSORTED_FEATURE_TOL = 1e-5
UNSORTED_FIJ_TOL = 1e-4
UNSORTED_GRAD_TOL = 1e-3
# a convolution's denominator is one scalar whose gradient sums the whole
# block output against its cotangent, which largely cancels: the first
# reading on the card put 3_convolution/denominator at 1.04e-3 (every
# other leaf at most 2.9e-6), so the denominators get about twice that
UNSORTED_DENOMINATOR_TOL = 2e-3
# the serving limits of PERF.md section 2
GOLDEN_ENERGY_TOL = 2e-6
GOLDEN_FIJ_TOL = 1e-4
TRAIN_TERMS = ('Total', 'Energy', 'Force', 'Stress', 'EWC')
# per-step loss: the first step within 1e-4 of the JAX total (float32 sums
# in another order through the double backward); later steps within
# TRAJ_TOL -- adam's first step moves every leaf by about +-lr whatever the
# size of its gradient, so a gradient element that is zero up to rounding
# may move either way in the two packages (PERF.md gives the measurement)
STEP0_TOL = 1e-4
TRAJ_TOL = 5e-2
# first-step gradients, per leaf, relative to the leaf's max|g|: on the
# 12-atom structure 1e-3 (float32 sums in another order through the double
# backward).  At batch 8 the gradient of the converged checkpoint is a sum
# over eight structures whose contributions largely cancel (max|g| 1e-7 to
# 1e-4), so the same absolute rounding is a larger share of it.  The
# float64 run (--f64-reference, PERF.md) puts every other leaf of the card
# within 1.2e-2 of float64 and of the JAX golden within 2.1e-2, and card
# against JAX within 9.2e-3 but for the three leaves named below: 2e-2
GRAD_TOL = {'ft12': 1e-3, 'ft900': 2e-2}
# leaves with their own limit, each about twice its card-vs-JAX reading.
# ft12: the atomic-energy shift's gradient is the per-atom energy residual,
# which float32 resolves to ~1e-2 relative.  ft900 (readings against
# float64 as card / JAX): the last denominator's gradient (max|g| 2e-7) is
# rounding, 0.16 / 0.21, card vs JAX 6.5e-2; the energy scale 1.2e-2 /
# 2.9e-2, card vs JAX 2.6e-2; the energy readout 6.0e-3 / 2.1e-2, card vs
# JAX 2.1e-2 -- the JAX golden is the one farther from float64
GRAD_TOL_LEAF = {
    'ft12': {('rescale_atomic_energy', 'shift'): 2e-2},
    'ft900': {('4_convolution', 'denominator'): 1e-1,
              ('rescale_atomic_energy', 'scale'): 5e-2,
              ('reduce_hidden_to_energy', 'w0'): 4e-2}}
# the pipeline phase (the port's CLI against golden/pipeline_ft_jax_cpu.npz):
# - a Fisher leaf is the mean over four batch-1 samples of g^2, so a
#   relative gradient error e moves it by about 2e: twice the batch-1
#   gradient limits of the 12-atom check above, per leaf's max|F|;
PIPELINE_FISHER_TOL = 2 * GRAD_TOL['ft12']
PIPELINE_FISHER_TOL_LEAF = {k: 2 * v for k, v in GRAD_TOL_LEAF['ft12'].items()}
# - log.csv: the first epoch's train columns are the first step's forward
#   at the checkpoint's parameters, held at the first-step limit STEP0_TOL
#   of their JAX value; every later value (memory and valid of epoch 1
#   come after the first update) at TRAJ_TOL.  Each limit adds the float32
#   floor of the quantity, the serving limits of PERF.md section 2 (energy
#   2e-6 of the mean |E| per atom of the stage's data, forces and stress
#   1e-4 of their max |value|): an error metric moves by at most the error
#   of the prediction it measures.
PIPELINE_EPOCH1_TOL = STEP0_TOL
PIPELINE_LATER_TOL = TRAJ_TOL
# the md phase: the golden run's settings (tests/test_torch_md.py's MD and
# D3, which a CPU test holds equal to these)
GOLDEN_MD = PKG / 'golden/md_hfo2_jax_cpu.npz'
MD = dict(T=500.0, seed=0, dt=2.0, skin=0.5, seg_steps=10, n_steps=20,
          n_steps_d3=10)
MD_D3 = {'functional': 'pbe', 'damping': 'bj'}
# against the JAX-CPU golden: positions after the run, E_pot each step; the
# D3 energy, and its forces and stress per max|.| (float32 sums over ~709k
# pairs in another order); the GNN + D3 totals at the serving limits
MD_POS_TOL = 1e-4
MD_EPOT_TOL = 1e-5
# E_kin and the final velocities at the CPU test's limits
# (tests/test_torch_md.py): E_kin 1e-4 rel, |dv| <= 1e-6 + 1e-3 |v| A/fs
MD_EKIN_TOL = 1e-4
MD_VEL_ATOL, MD_VEL_RTOL = 1e-6, 1e-3
D3_ENERGY_TOL = 1e-5
D3_TERM_TOL = 1e-4
# the 2x2x2 replicate: E_pot 8x the cell's, the replicas' forces equal
# (per max|f|), and the JAX package's NVE bound (tests/test_md_device.py)
MD_EXTENSIVE_TOL = 1e-5
MD_REPLICA_FORCE_TOL = 1e-4
MD_DRIFT_TOL = 5e-4
# steps: the host loop against the device loop from the same start, the
# 768-atom device run, the FCTP model's device run; then the timed runs
MD_RUN_STEPS = 10
MD768_STEPS = 20
FCTP_STEPS = 5
MD_TIMED_STEPS = {'96': 20, '96 d3': 10, '768': 20, '768 d3': 5}
MD_TIMED_RUN_STEPS = {'96': 10, '96 d3': 3, '768': 5, '768 d3': 2}
# launches of one force evaluation (segment sums: the least), the serve
# census: the energy, the two force sums, the virial and the src-side
# scatter of blocks 1-4; D3 adds five segment sums (its coordination sum,
# and the scatters by i and j of the backward of its gathers of the
# coordination numbers and of the positions)
MD_CENSUS = {'cg_agg': 5, 'cg_multi': 5, 'segment_sum': 8}
D3_SEGMENT_SUMS = 5
# the FCTP model (EXAMPLE_MD_MODEL) has four convolutions
FCTP_CENSUS = {'cg_agg': 4, 'cg_multi': 4, 'segment_sum': 7}
# the families phase (golden/families_jax_cpu.npz: its configurations,
# JAX-CPU serving of ft.extxyz and three train steps of MACE and Gaunt on
# ft900 structure 0): the kernels it captures, and the launches of one
# request and of one train step per family (PERF.md explains each count).
# Serving is held at the serving limits; the first train step's loss at
# STEP0_TOL and later steps at TRAJ_TOL; every leaf's first-step gradient
# within GRAD_TOL (1e-3) of its max|g| (the port's plain CPU run read at
# most 2.3e-6 for MACE and 4.1e-6 for Gaunt against the golden)
GOLDEN_FAMILIES = PKG / 'golden/families_jax_cpu.npz'
FAMILY_KERNELS = ('segment_sum', 'cg_agg', 'cg_multi', 'cg_gagg',
                  'cg_gmulti')
FAMILY_SERVE_CENSUS = {
    'mace_mp0_medium_widths': {'cg_agg': 2, 'cg_multi': 2,
                               'segment_sum': 5},
    'gaunt_sevennet0_widths': {'cg_agg': 1, 'cg_multi': 1,
                               'segment_sum': 8},
    'gaunt_gate_sevennet0_widths': {'cg_agg': 2, 'cg_multi': 2,
                                    'segment_sum': 11}}
FAMILY_TRAIN_CENSUS = {
    'mace_mp0_medium_widths': {'cg_agg': 2, 'cg_multi': 4, 'cg_gagg': 2,
                               'cg_gmulti': 2, 'segment_sum': 7},
    'gaunt_sevennet0_widths': {'cg_agg': 1, 'cg_multi': 2, 'cg_gagg': 1,
                               'cg_gmulti': 1, 'segment_sum': 13}}
FAMILY_TERMS = ('Total', 'Energy', 'Force', 'Stress')
GRAD_TOL.update(dict.fromkeys(FAMILY_TRAIN_CENSUS, 1e-3))
# the energy limit of a family where the serving limit lies under the
# model's own float32 error: gaunt_sevennet0_widths at init grows its
# features ~x^3 a block (1.8e8 after block 2) and its atomic energies
# cancel 4:1, so float32 lies 4.4e-6 to 6.9e-6 from float64 on the port's
# CPU run and 4.8e-6 to 7.1e-6 in the JAX golden (96- and 12-atom
# structures): two float32 runs may part by ~1.4e-5 (the card read
# 1.10e-5 on the 12-atom structure); about twice that
FAMILY_ENERGY_TOL = {'gaunt_sevennet0_widths': 3e-5}
# each raw loss term (not weighted by its share of the total) at the
# checkpoint's parameters, batch 8: within 2e-3 of its JAX value (readings
# up to 4.7e-4, the energy term's float32 residual; ft12's 12-atom energy
# term is too small to resolve and is held by the total-weighted check)
RAW_TERM_TOL = 2e-3

# the compat phase (checkpoint and deploy interop; PERF.md section 4):
# - the continue of the in-repo checkpoint with its own adam state, two
#   batch-8 steps at LR 1e-4 (tests/test_torch_optax_state.py makes it)
GOLDEN_CONTINUE = PKG / 'golden/continue_ft900_jax_cpu.npz'
# - the parallel TorchScript chain over ft.extxyz structure 0 in one
#   domain against the serving golden: ten times the CPU reading (6.4e-7
#   eV/atom, forces 1.88e-5 eV/A; torch 2.13 on the CPU), inside the JAX
#   test's own 1e-4 eV/atom and 2e-4 eV/A
PAR_ENERGY_TOL = 6.4e-6
PAR_FORCE_TOL = 1.9e-4
# - a .sevenn_data fine-tune against the pipeline phase's extxyz one: the
#   same graphs, seed and deterministic sums
COMPAT_CSV_TOL = 1e-6
# - what compat/torchscript_import reads from the serial artifact of
#   SevenNet-0 that get_model --torchscript writes, frozen by torch 2.13 on
#   the CPU: the weighted ops' shapes in graph order, and the parsed config
#   without its type map.  Cutoff, species, channel, the 8 Bessel
#   functions and the XPLOR cutoff at 4.5 are SevenNet-0's; lmax 1 and
#   _normalize_sph False are the parser's defaults (it looks for e3nn's
#   sh_l_m names and clamp_min, which the exporter's graph, with its
#   monomial SH tables, does not hold), as the JAX parser reads them too
TS_WEIGHT_OP_SHAPES = (
    (8,), (1, 1), (3, 3), (6, 5), (89, 128), (128,), (128, 576),
    (128, 128), (128,), (1152, 576), (576,), (480, 576), (480, 480),
    (480,), (3136, 576), (576,), (480, 576), (480, 480), (480,),
    (3136, 576), (576,), (480, 576), (480, 480), (480,), (3136, 576),
    (576,), (480, 128), (480, 480), (480,), (224, 128), (128,), (128, 64),
    (64,), (64, 1), (1,), (89,), (89,))
TS_FROZEN_CONFIG = {
    '_number_of_species': 89, 'cutoff': 5.0, 'channel': 128, 'lmax': 1,
    'is_parity': True, 'num_convolution_layer': 3,
    'radial_basis': {'radial_basis_name': 'bessel', 'bessel_basis_num': 8},
    'cutoff_function': {'cutoff_function_name': 'XPLOR', 'cutoff_on': 4.5},
    '_normalize_sph': False, 'self_connection_type': 'nequip',
    'conv_denominator': 1.0, 'shift': 0.0, 'scale': 1.0}

def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters=20):
    """ms per call of fn between two CUDA events after warm-up."""
    from sevennet_finetuning_tpu_torch.tools.bench_dma import time_ms

    return time_ms(lambda i: fn(), n_it=iters)


def bound_ms(n_bytes, n_flop, flop_per_s=FP32_FLOP_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flop / flop_per_s * 1e3
    return max(t_bytes, t_ops), ('bytes' if t_bytes >= t_ops else
                                 'operations')


def compare(name, got, want, tol=KERNEL_TOL):
    """max|got - want| <= tol * max|want| over the outputs (tol 0: equal
    values, the probes' bit-equality); returns max|got - want|."""
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = max(float((g.float() - w.float()).abs().max())
              for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    ok = err <= tol * scale and all(g.dtype == w.dtype
                                    for g, w in zip(got, want))
    log(f'  {name}: max_abs_err {err:.3e}, max|plain| {scale:.3e} '
        f'({"ok" if ok else "FAIL"} at {tol:g} rel)')
    if not ok:
        raise AssertionError(f'{name}: kernel disagrees with its plain '
                             f'version ({err:.3e} > {tol:g} * '
                             f'{scale:.3e})')
    return err


def same_bits(name, fn):
    """Two launches of fn on the same inputs give the same bits (the
    kernels sum in a fixed order, with no atomics)."""
    import torch

    a, b = fn(), fn()
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f'{name}: two launches on the same inputs '
                             'differ')
    log(f'  {name}: two launches bit-identical')


def device_us_per_call(fn):
    """Device us a call of fn (``bench_dma.device_us_per_call``), None
    where the profiler records no device event."""
    from sevennet_finetuning_tpu_torch.tools.bench_dma import (
        device_us_per_call as us_per_call)

    return us_per_call(fn)


def host_us_per_call(fn, n=200):
    """Host time per call of fn in microseconds, n calls without a sync
    between them (each call queues work far shorter than the call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return dt


def train_segment_shapes(n_edge, n_node, n_graph):
    """(E, D, n_rows) of each segment_sum launch of one train step, with
    its count: the per-graph energy (one row per node) and virial, the
    two force sums, and the src-side scatters of the node features that
    the force pass and the outer backward run for blocks 1-4 (width 480)
    and 0 (width 128, the outer backward only)."""
    return {(n_node, 1, n_graph): 1, (n_edge, 480, n_node): 8,
            (n_edge, 3, n_node): 2, (n_edge, 6, n_graph): 1,
            (n_edge, 128, n_node): 1}


def phase_build():
    from sevennet_finetuning_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build_all()
    dt = time.perf_counter() - t0
    log(f'[build] {len(_cuda.SOURCES)} sources ({len(_cuda.KERNELS)} entry '
        f'points) built in {dt:.1f} s')
    for name in _cuda.SOURCES:
        for line in _cuda.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'  {name}: {line.strip()}')


def phase_probes():
    """The probe kernels of ``tools`` (kernel table rows 8a-9d) at the TPU
    tools' shapes against their plain versions, with times; then both
    tools' entry points as a user runs them, with the launch counts set
    to 0 just before and read just after.  Returns (rows, counts)."""
    import numpy as np
    import torch

    from sevennet_finetuning_tpu_torch.ops import _cuda
    from sevennet_finetuning_tpu_torch.tools import bench_dma as B
    from sevennet_finetuning_tpu_torch.tools import hopper_feats as H

    t_phase = time.perf_counter()
    dev = torch.device('cuda')
    rng = np.random.default_rng(0)
    # N_SLABS input and output slabs taken in turn: no launch finds its
    # input in the 50 MB L2
    xs = [torch.as_tensor(rng.standard_normal((B.E, B.D), dtype=np.float32),
                          device=dev) for _ in range(B.N_SLABS)]
    ys = [torch.empty_like(x) for x in xs]
    nbytes = B.E * B.D * 4

    def slab_ms(fn):
        return B.time_ms(lambda i: fn(i % B.N_SLABS))

    def slab_device_us(fn):
        turn = itertools.count()
        return device_us_per_call(lambda: fn(next(turn) % B.N_SLABS))

    log(f'[probes] slabs of {B.E} x {B.D} float32 ({nbytes} bytes), '
        f'{B.N_SLABS} in turn')
    rows = {}
    # warm-up: the card's clocks, the slabs' first touch
    slab_ms(lambda i: torch.mul(xs[i], B.C, out=ys[i]))

    def copy_case(name, label, xv, yv, kern):
        """One case of 8a / 8c: kern(x, out=None) bit for bit against the
        plain version, then timed beside torch.mul on the same slabs
        (CUDA events over B.N_IT launches, profiler device us a call)."""
        err = compare(f'{name} {label}', kern(xv[0]),
                      B.copy_tiled_plain(xv[0]), 0.0)
        b_ms, b_by = bound_ms(2 * nbytes, B.E * B.D)
        case = dict(
            shape=f'{label}: [{xv[0].shape[0]}, {xv[0].shape[1]}] f32',
            max_abs_err=err,
            library_ms=slab_ms(lambda i: torch.mul(xv[i], B.C, out=yv[i])),
            ms=slab_ms(lambda i: kern(xv[i], out=yv[i])),
            plain_ms=slab_ms(lambda i: B.copy_tiled_plain(xv[i])),
            library_device_us=slab_device_us(
                lambda i: torch.mul(xv[i], B.C, out=yv[i])),
            device_us=slab_device_us(lambda i: kern(xv[i], out=yv[i])),
            bound_ms=b_ms, bound_by=b_by)
        case['factor'] = case['ms'] / case['library_ms']
        if case['device_us'] and case['library_device_us']:
            case['device_factor'] = (case['device_us']
                                     / case['library_device_us'])
        return case

    # 8a: tiled copy at every tile of the TPU sweep, row tiles (em) and
    # column strips (fm)
    cases = []
    for te, fm in ([(te, False) for te in B.EM_TILES]
                   + [(te, True) for te in B.FM_TILES]):
        shape = (B.D, B.E) if fm else (B.E, B.D)
        cases.append(copy_case(
            'probe_copy_tiled', f'{"fm" if fm else "em"} te={te}',
            [x.view(shape) for x in xs], [y.view(shape) for y in ys],
            lambda x, out=None, te=te, fm=fm: B.copy_tiled_cuda(
                x, te, fm, out=out)))
    rows['probe_copy_tiled'] = cases

    # 8b: column sum, within 2e-6 x the column's sum of |x|
    cases = []
    for te in B.READ_TILES:
        got = B.colsum_cuda(xs[0], te)
        want = B.colsum_plain(xs[0], te)
        x64 = xs[0].double()
        scale = x64.abs().sum(0, keepdim=True)
        err_rel = float(((got.double() - want.double()).abs() / scale).max())
        ref_rel = float(((got.double() - x64.sum(0, keepdim=True)).abs()
                         / scale).max())
        err = float((got - want).abs().max())
        ok = err_rel <= KERNEL_TOL and ref_rel <= KERNEL_TOL
        log(f'  probe_colsum te={te}: max_abs_err {err:.3e}, max err / '
            f'sum|x| {err_rel:.2e} vs plain, {ref_rel:.2e} vs float64 '
            f'({"ok" if ok else "FAIL"} at {KERNEL_TOL:g})')
        if not ok:
            raise AssertionError(f'probe_colsum te={te} disagrees with its '
                                 'plain version or the float64 sum')
        same_bits(f'probe_colsum te={te}', lambda: B.colsum_cuda(xs[0], te))
        b_ms, b_by = bound_ms(nbytes + 4 * B.D, B.E * B.D)
        cases.append(dict(
            shape=f'te={te}: [{B.E}, {B.D}] -> [1, {B.D}]', max_abs_err=err,
            bit_identical=True,
            device_us=device_us_per_call(lambda: B.colsum_cuda(xs[0], te)),
            library_device_us=device_us_per_call(
                lambda: torch.sum(xs[0], 0, keepdim=True)),
            ms=slab_ms(lambda i: B.colsum_cuda(xs[i], te)),
            plain_ms=slab_ms(lambda i: B.colsum_plain(xs[i], te)),
            library_ms=slab_ms(lambda i: torch.sum(xs[i], 0, keepdim=True)),
            bound_ms=b_ms, bound_by=b_by))
    rows['probe_colsum'] = cases

    # 8c: the bulk-copy rings at every shape of the sweep
    cases = []
    for v in B.ring_variants():
        cases.append(copy_case(
            'probe_copy_ring', f'rows={v[0]} slots={v[1]} split={v[2]}',
            xs, ys,
            lambda x, out=None, v=v: B.copy_ring_cuda(x, *v, out=out)))
        cases[-1]['smem_bytes'] = B.ring_smem_bytes(v[0], v[1])
    rows['probe_copy_ring'] = cases
    for name in ('probe_copy_tiled', 'probe_copy_ring'):
        worst = max(rows[name], key=lambda c: c['factor'])
        log(f'  {name}: worst factor against torch.mul {worst["factor"]:.3f} '
            f'({worst["shape"]}), best '
            f'{min(c["factor"] for c in rows[name]):.3f}')

    # 9a-9d at the TPU probe's shapes
    t = {k: torch.as_tensor(v, device=dev)
         for k, v in H.probe_inputs().items()}
    x, v, a, b, y, sel = (t[k] for k in ('x', 'v', 'a', 'b', 'y', 'sel'))
    xt = torch.empty(x.shape[::-1], device=dev)
    n = v.numel()
    wbytes = y.shape[0] // H.N_WINDOWS * y.shape[1] * 4
    m, k_dim, n_te = a.shape[1], a.shape[0], b.shape[1]
    probes = (
        # the kernel and its library call both write into xt
        ('probe_transpose', f'[{x.shape[0]}, {x.shape[1]}] f32',
         0.0, lambda: H.transpose_cuda(x, out=xt),
         lambda: H.transpose_plain(x), lambda: xt.copy_(x.t()),
         (2 * 4 * x.numel(), 0, FP32_FLOP_PER_S)),
        # read x, write the f32 sum and three bf16 parts; ~9 fp32
        # operations per element (2 masks, 2 subtractions, 3 conversions,
        # 2 additions)
        ('probe_split', f'[{v.shape[0]}, {v.shape[1]}] f32 (x 100)',
         0.0, lambda: H.split_cuda(v), lambda: H.split_plain(v),
         None, (4 * n + 4 * n + 6 * n, 9 * n, FP32_FLOP_PER_S)),
        # six bf16 products of 2 M N K operations on the tensor cores
        ('probe_dot', f'a [{k_dim}, {m}]^T b [{k_dim}, {n_te}] f32',
         KERNEL_TOL, lambda: H.dot_cuda(a, b), lambda: H.dot_plain(a, b),
         lambda: torch.matmul(a.t(), b),
         (4 * (a.numel() + b.numel() + m * n_te), 6 * 2 * m * n_te * k_dim,
          BF16_TC_FLOP_PER_S)),
        ('probe_window', f'window {int(sel[0])} of {H.N_WINDOWS} x '
         f'[{y.shape[0] // H.N_WINDOWS}, {y.shape[1]}] f32',
         0.0, lambda: H.window_cuda(y, sel),
         lambda: H.window_plain(y, sel),
         lambda: torch.index_select(y.view(H.N_WINDOWS, -1), 0, sel),
         (2 * wbytes + 4, 0, FP32_FLOP_PER_S)),
    )
    # the floor: bench_dma's overhead control, one block copying 4 KB into
    # a preallocated output, the card's device time for a launch that
    # moves almost nothing; each of 9a-9d is read beside it
    tiny = torch.ones(8, 128, device=dev)
    tiny_out = torch.empty_like(tiny)
    floor_us = device_us_per_call(
        lambda: B.copy_tiled_cuda(tiny, 8, out=tiny_out))
    log(f'  floor (bench_dma overhead control, [8, 128] into a preallocated '
        f'output): {floor_us} device us a call; {B.card_line()}')
    for name, shape, tol, kern, plain, library, (nb, nf, peak) in probes:
        err = compare(f'{name} [{shape}]', kern(), plain(), tol)
        same_bits(name, kern)
        b_ms, b_by = bound_ms(nb, nf, peak)
        case = dict(
            shape=shape, max_abs_err=err, bit_identical=True,
            ms=cuda_ms(kern, iters=PROBE_IT),
            plain_ms=cuda_ms(plain, iters=PROBE_IT),
            library_ms=None if library is None else cuda_ms(
                library, iters=PROBE_IT),
            device_us=device_us_per_call(kern),
            library_device_us=None if library is None else
            device_us_per_call(library),
            floor_device_us=floor_us, bound_ms=b_ms, bound_by=b_by)
        if case['device_us'] and case['library_device_us']:
            case['device_factor'] = (case['device_us']
                                     / case['library_device_us'])
        if case['device_us'] and floor_us:
            case['device_us_over_floor'] = case['device_us'] - floor_us
        rows[name] = [case]
    # the window at the first, a middle and the last selector, bit for
    # bit, and zeros for a selector out of range; the transpose and the
    # split at a ragged shape each
    for s in (0, 5, H.N_WINDOWS - 1, H.N_WINDOWS):
        sv = torch.tensor([s], dtype=torch.int32, device=dev)
        got = H.window_cuda(y, sv)
        compare(f'probe_window sel={s}', got, H.window_plain(y, sv), 0.0)
        if s == H.N_WINDOWS and bool(got.any()):
            raise AssertionError('probe_window: a selector out of range '
                                 'gave non-zeros')
    xr = torch.as_tensor(rng.standard_normal((36, 20), dtype=np.float32),
                         device=dev)
    compare('probe_transpose [36, 20]', H.transpose_cuda(xr),
            H.transpose_plain(xr), 0.0)
    vr = torch.as_tensor((rng.standard_normal(4100) * 100).astype(np.float32),
                         device=dev)
    parts, recon = H.split_cuda(vr)
    compare('probe_split n=4100', (parts, recon), H.split_plain(vr), 0.0)
    compare('probe_split n=4100 recon against x', recon, vr, 0.0)

    for name, cases in rows.items():
        for c in cases:
            lib = ('n/a' if c['library_ms'] is None
                   else f'{c["library_ms"]:.4f} ms')
            dev = ''
            if 'device_us' in c:
                dev = (f'; device us a call {c["device_us"]}, library '
                       f'{c.get("library_device_us")}')
            if 'device_us_over_floor' in c:
                dev += (f', floor {c["floor_device_us"]:.3f}, over it '
                        f'{c["device_us_over_floor"]:.3f}')
            log(f'  {name} [{c["shape"]}]: kernel {c["ms"]:.4f} ms, plain '
                f'{c["plain_ms"]:.4f} ms, library {lib}, bound '
                f'{c["bound_ms"] * 1e3:.2f} us ({c["bound_by"]}){dev}')

    # the probes' own entry points, as a user runs them
    torch.cuda.synchronize()
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    rc = {'hopper_feats': H.main(), 'bench_dma': B.main()}
    torch.cuda.synchronize()
    counts = {k: _cuda.LAUNCHES[k] for k in _cuda.KERNELS}
    log(f'[probes] hopper_feats.main and bench_dma.main in '
        f'{time.perf_counter() - t0:.1f} s: exit codes {rc}, launches '
        f'{ {k: counts[k] for k in PROBES} }')
    if any(rc.values()):
        raise AssertionError(f'a probe failed: exit codes {rc}')
    if any(counts[k] for k in counts if k not in PROBES):
        raise AssertionError(f'the probes launched a model kernel: {counts}')
    log(f'[probes] phase done in {time.perf_counter() - t_phase:.1f} s')
    return rows, counts


def batch8(calc):
    """Batch-8 collate of the first eight 96-atom structures of ft900."""
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.model.graph import (
        bucket_capacity, collate, structure_to_graph)
    from sevennet_finetuning_tpu_torch.model.nequip import batch_to_torch

    structs = [s for s in read_extxyz(str(FT900)) if len(s) == 96][:BATCH]
    graphs = [structure_to_graph(s, calc.spec.cutoff, calc.type_map)
              for s in structs]
    n_edge = sum(g[K.EDGE_IDX].shape[1] for g in graphs)
    b = collate(graphs, n_node=96 * BATCH, n_edge=bucket_capacity(n_edge),
                n_graph=BATCH)
    return batch_to_torch(b, calc.device), n_edge


def conv_kernel_cases(t, layout, dst, N, randn, x_grad=True):
    """cg_agg, cg_multi, cg_gagg and cg_gmulti at one convolution layout
    on random legs of every edge slot of ``dst`` (ascending, sentinel N):
    each held against its plain version (``KERNEL_TOL``), the same bits in
    two launches, timed beside its plain version and its bound.  ``t``
    labels the cases; ``x_grad`` False drops the xn job from the block's
    jobs (block 0's input, the embedding, needs no cotangent).  Returns
    the four lists of cases."""
    import torch

    from sevennet_finetuning_tpu_torch.ops import _cuda
    from sevennet_finetuning_tpu_torch.ops.cg_tables import (
        gmulti_passes, gmulti_term_count)
    from sevennet_finetuning_tpu_torch.ops.fused_conv_agg import (
        _EMIT, agg_config, agg_cuda, agg_plain)
    from sevennet_finetuning_tpu_torch.ops.fused_conv_multi import (
        _EMIT_LEGS, _JOB_LEGS, gagg_cuda, gagg_plain, gmulti_cuda,
        gmulti_plain, multi_cuda, multi_plain)

    E = dst.shape[0]
    live = int((dst < N).sum())
    agg_cases, multi_cases, gagg_cases, gmulti_cases = [], [], [], []
    x = randn(E, layout.dim_x)
    sh = randn(E, layout.dim_sh)
    w = randn(E, layout.dim_w)
    # x/sh/w rows of padded edges are never needed: the agg sum ends
    # at the last live edge and multi's outputs there are zero
    dims = {'x': layout.dim_x, 'sh': layout.dim_sh, 'w': layout.dim_w}
    leg_bytes = 4 * live * sum(dims.values())

    def job_leg_bytes(jobs):
        # the legs the jobs read: xn needs sh and w, shn x and w, wn x
        # and sh
        return 4 * live * sum(dims[leg] for leg in
                              {leg for j in jobs for leg in _JOB_LEGS[j]})

    got = agg_cuda(x, sh, w, dst, layout, N)
    want = agg_plain(x, sh, w, dst, layout, N)
    err = compare(f'cg_agg {t}', got, want)
    same_bits(f'cg_agg {t}',
              lambda: agg_cuda(x, sh, w, dst, layout, N))
    # one-term cg_gagg computes the same function (fusing the w
    # product into its sums, where cg_agg rounds it as JAX does): the
    # yardstick, timed below (cg_gagg's "1 term" case)
    same = torch.equal(got, gagg_cuda([x, sh, w], dst, ((0, 1, 2),),
                                      layout, N))
    log(f'  cg_agg {t}: the same bits as one-term cg_gagg: '
        f'{same}')
    # the bound counts the per-term table the first kernel read, so
    # the times of every PR compare
    n_terms = gmulti_term_count(layout, 1)
    b_ms, b_by = bound_ms(
        leg_bytes + 4 * E + 4 * N * layout.dim_msg + 16 * n_terms,
        live * (4 * n_terms + layout.dim_msg))
    agg_cases.append(dict(
        shape=f'{t}: E={E} N={N} dims x/sh/w/msg '
              f'{layout.dim_x}/{layout.dim_sh}/{layout.dim_w}/'
              f'{layout.dim_msg}, launch {agg_config(layout)}',
        max_abs_err=err, bit_identical=True,
        ms=cuda_ms(lambda: agg_cuda(x, sh, w, dst, layout, N)),
        plain_ms=cuda_ms(lambda: agg_plain(x, sh, w, dst, layout, N),
                         iters=5),
        library_ms=None, bound_ms=b_ms, bound_by=b_by,
        device_us=device_us_per_call(
            lambda: agg_cuda(x, sh, w, dst, layout, N))))

    # the block's jobs (block 0's input, the embedding, needs no
    # cotangent), one job each of xn, shn, wn (the counterpart of
    # bwd_pallas, row 4), and xn + wn: the outer backward's jobs
    # without the shn cotangent that the train step computes but does
    # not need.  The bound counts the per-term table the first
    # kernel read, so the times compare
    ybar = randn(N, layout.dim_msg)
    for sub, label in (
            (('xn', 'shn', 'wn') if x_grad else ('shn', 'wn'), 'jobs'),
            (('xn',), 'single job'), (('shn',), 'single job'),
            (('wn',), 'single job'), (('xn', 'wn'), 'jobs (no shn)')):
        got = multi_cuda(ybar, x, sh, w, dst, sub, layout, N)
        want = multi_plain(ybar, x, sh, w, dst, sub, layout, N)
        err = compare(f'cg_multi {t} {sub}', got, want)
        same_bits(f'cg_multi {t} {sub}',
                  lambda: multi_cuda(ybar, x, sh, w, dst, sub, layout, N))
        n_terms = gmulti_term_count(layout, len(sub))
        b_ms, b_by = bound_ms(
            job_leg_bytes(sub) + 4 * E + 4 * N * layout.dim_msg
            + 4 * E * sum(dims[_EMIT[j]] for j in sub) + 16 * n_terms,
            live * 4 * n_terms)
        multi_cases.append(dict(
            shape=f'{t} {label} {"+".join(sub)}: E={E} N={N}',
            max_abs_err=err, bit_identical=True,
            ms=cuda_ms(lambda: multi_cuda(ybar, x, sh, w, dst, sub,
                                          layout, N)),
            plain_ms=cuda_ms(lambda: multi_plain(
                ybar, x, sh, w, dst, sub, layout, N), iters=5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))

    # the double backward at this block: cotangents of xn / shn / wn
    cx = randn(E, layout.dim_x)
    cs = randn(E, layout.dim_sh)
    cw = randn(E, layout.dim_w)
    pool = [x, sh, w, cx, cs, cw]
    pool_dims = tuple(p.shape[1] for p in pool)

    def pool_bytes(used):
        # the live rows of the pool arrays that the terms / jobs read
        return 4 * live * sum(pool_dims[i] for i in set(used))

    # CGNodeMulti.backward's three terms; then one term on [x, sh, w],
    # cg_agg's function (its yardstick).  The bound counts the
    # per-term table the first kernel read, whose entries are the
    # scalar couplings x terms, so the times compare
    terms = ((0, 1, 5), (0, 4, 2), (3, 1, 2))
    for tm, label in ((terms, '3 terms'),
                      (((0, 1, 2),), "1 term (cg_agg's function)")):
        got = gagg_cuda(pool, dst, tm, layout, N)
        want = gagg_plain(pool, dst, tm, layout, N)
        err = compare(f'cg_gagg {t} {label}', got, want)
        same_bits(f'cg_gagg {t} {label}',
                  lambda: gagg_cuda(pool, dst, tm, layout, N))
        n_terms = gmulti_term_count(layout, len(tm))
        b_ms, b_by = bound_ms(
            pool_bytes(i for term in tm for i in term)
            + 4 * E + 4 * N * layout.dim_msg + 16 * n_terms,
            live * (4 * n_terms + len(tm) * layout.dim_msg))
        gagg_cases.append(dict(
            shape=f'{t} {label}: E={E} N={N}', max_abs_err=err,
            bit_identical=True,
            ms=cuda_ms(lambda: gagg_cuda(pool, dst, tm, layout, N)),
            plain_ms=cuda_ms(lambda: gagg_plain(pool, dst, tm, layout,
                                                N), iters=5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))

    # CGNodeMulti.backward's jobs; then without the sh group, whose
    # cotangent the train step computes but does not need
    full = ((('x', 1, 5, 'x'), ('x', 4, 2, 'x'), ('sh', 0, 5, 'sh'),
             ('sh', 3, 2, 'sh'), ('w', 0, 4, 'w'), ('w', 3, 1, 'w')),
            ('x', 'sh', 'w'))
    no_sh = (tuple(j for j in full[0] if j[3] != 'sh'), ('x', 'w'))
    # CGNodeGAgg.backward of the gagg terms above with every leg live
    # (a third order): three jobs of each emit mode, several passes
    gagg_bwd = (tuple((leg, idx[b], idx[c], idx[leg])
                      for term in terms
                      for idx in [dict(zip(('x', 'sh', 'w'), term))]
                      for leg, (b, c) in _EMIT_LEGS.items()),
                tuple(sorted({i for term in terms for i in term})))
    for label, (jobs, groups) in (('6 jobs x/sh/w', full),
                                  ('4 jobs x/w (no sh)', no_sh),
                                  ('9 jobs of a gagg backward',
                                   gagg_bwd)):
        gi = {g: i for i, g in enumerate(groups)}
        n_pass = len(gmulti_passes(
            tuple((m, b, c, gi[g]) for m, b, c, g in jobs), len(groups)))
        label = f'{label}, {n_pass} pass{"es" if n_pass > 1 else ""}'
        before = _cuda.LAUNCHES['cg_gmulti']
        got = gmulti_cuda(ybar, pool, dst, jobs, groups, layout, N)
        if _cuda.LAUNCHES['cg_gmulti'] - before != n_pass:
            raise AssertionError(f'cg_gmulti {t} {label}: counted '
                                 f'{_cuda.LAUNCHES["cg_gmulti"] - before}'
                                 f' launches for {n_pass} passes')
        want = gmulti_plain(ybar, pool, dst, jobs, groups, layout, N)
        err = compare(f'cg_gmulti {t} {label}', got, want)
        same_bits(f'cg_gmulti {t} {label}',
                  lambda: gmulti_cuda(ybar, pool, dst, jobs, groups,
                                      layout, N))
        # the function's scalar couplings x jobs, counted as a table
        # of 16-byte terms with 4 operations each, as the bound of the
        # per-term table the first kernel read, so the times compare
        n_terms = gmulti_term_count(layout, len(jobs))
        b_ms, b_by = bound_ms(
            pool_bytes(i for _, b, c, _ in jobs for i in (b, c))
            + 4 * E + 4 * N * layout.dim_msg
            + 4 * E * sum(g.shape[1] for g in got) + 16 * n_terms,
            live * 4 * n_terms)
        gmulti_cases.append(dict(
            shape=f'{t} {label}: E={E} N={N}', max_abs_err=err,
            bit_identical=True,
            ms=cuda_ms(lambda: gmulti_cuda(ybar, pool, dst, jobs, groups,
                                           layout, N)),
            plain_ms=cuda_ms(lambda: gmulti_plain(
                ybar, pool, dst, jobs, groups, layout, N), iters=5),
            library_ms=None, bound_ms=b_ms, bound_by=b_by))
    return agg_cases, multi_cases, gagg_cases, gmulti_cases


def phase_kernels(calc, batch, n_real_edge):
    import torch

    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.ops import scatter
    from sevennet_finetuning_tpu_torch.ops.fused_conv import (
        _MODE_LEGS, _MODE_OUT, layout_from_spec)
    from sevennet_finetuning_tpu_torch.ops.fused_conv_kernel import (
        quad_config, quad_cuda, quad_plain)

    dev = calc.device
    dst = batch[K.EDGE_IDX][0].contiguous()
    E = dst.shape[0]
    N = batch[K.POS].shape[0]
    live = int((dst < N).sum())
    gen = torch.Generator(device='cpu').manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    log(f'[kernels] batch-8 collate: N={N}, E={E} slots, {n_real_edge} '
        'real edges')
    rows = {}

    # --- sorted segment sum: D = 1, 6, 480 over the N = 768 nodes (the
    # kernel table's first rows), then each distinct shape a train step
    # launches (train_segment_shapes) on this collate ---
    G = BATCH
    graph_of_node = batch[K.BATCH].contiguous()
    graph_of_edge = torch.where(
        dst < N, graph_of_node[dst.clamp(max=N - 1).long()],
        torch.full_like(dst, G)).contiguous()
    seg_shapes = [(E, 1, N, dst, 'table'), (E, 6, N, dst, 'table'),
                  (E, 480, N, dst, 'table')]
    for (e, d, n), count in train_segment_shapes(E, N, G).items():
        idx = {(E, N): dst, (E, G): graph_of_edge,
               (N, G): graph_of_node}[(e, n)]
        if (e, d, n) not in [c[:3] for c in seg_shapes]:
            seg_shapes.append((e, d, n, idx, f'{count} per train step'))
    cases = []
    for e, D, n, idx, label in seg_shapes:
        msg = randn(e, D)
        got = scatter.segment_sum_cuda(msg, idx, n)
        # the plain version on the host adds each row's edges in edge
        # order, as the kernel and JAX do: the same bits.  (On the card
        # it adds in atomic order; a 4,800-edge float32 virial row then
        # lies ~2e-6 of max|plain| from the in-order sum.)
        want = scatter.segment_sum_plain(msg.cpu(), idx.cpu(), n)
        err = compare(f'segment_sum E={e} D={D} N={n}', got.cpu(), want,
                      0.0)
        same_bits(f'segment_sum E={e} D={D} N={n}',
                  lambda: scatter.segment_sum_cuda(msg, idx, n))
        idx_long = idx.long()

        def library():
            return torch.zeros(n + 1, D, device=dev).index_add_(
                0, idx_long, msg)

        # only the live edges' rows are read: the kernel's row ranges end
        # at the first sentinel edge
        n_live = int((idx < n).sum())
        b_ms, b_by = bound_ms(4 * (n_live * D + e + n * D), n_live * D)
        case = dict(
            shape=f'E={e} D={D} N={n} ({label}, '
                  f'{"staged" if scatter.segment_plan(e, D, n) else "rows"})',
            max_abs_err=err, bit_identical=True,
            ms=cuda_ms(lambda: scatter.segment_sum_cuda(msg, idx, n)),
            plain_ms=cuda_ms(lambda: scatter.segment_sum_plain(msg, idx, n)),
            library_ms=cuda_ms(library), bound_ms=b_ms, bound_by=b_by)
        # a call split into the kernel's device time (profiler) and the
        # wrapper's host time, index_add_'s device time (its zero fill
        # and its kernel) beside them
        case.update(
            device_us=device_us_per_call(
                lambda: scatter.segment_sum_cuda(msg, idx, n)),
            host_us=host_us_per_call(
                lambda: scatter.segment_sum_cuda(msg, idx, n)),
            library_device_us=device_us_per_call(library),
            library_host_us=host_us_per_call(library))
        log(f'  segment_sum E={e} D={D} N={n}: device '
            f'{case["device_us"]} us, host {case["host_us"]:.1f} us a call; '
            f'index_add_ device {case["library_device_us"]} us, host '
            f'{case["library_host_us"]:.1f} us')
        cases.append(case)
    rows['segment_sum'] = cases
    # the staged shape at its widest rows (one thread a column), and rows
    # one wider, which take the rows shape however long: the src-side
    # feature scatter (480) of a 12-atom graph in 1,024 edge slots
    for e, D, n in ((4096, scatter.STAGED_MAX_D, 16), (1024, 480, 12)):
        idx = torch.sort(torch.randint(0, n, (e,), generator=gen)).values
        idx = idx.to(torch.int32).to(dev)
        msg = randn(e, D)
        compare(f'segment_sum E={e} D={D} N={n} '
                f'(plan {scatter.segment_plan(e, D, n)})',
                scatter.segment_sum_cuda(msg, idx, n).cpu(),
                scatter.segment_sum_plain(msg.cpu(), idx.cpu(), n), 0.0)
        same_bits(f'segment_sum E={e} D={D} N={n}',
                  lambda: scatter.segment_sum_cuda(msg, idx, n))

    # --- agg / multi / gagg / gmulti at the layouts of blocks 0, 1, 4 ---
    agg_cases, multi_cases, gagg_cases, gmulti_cases = [], [], [], []
    quad_cases = []
    for t in (0, 1, 4):
        layout = layout_from_spec(calc.spec.blocks[t].conv_tp)
        for acc, got in zip((agg_cases, multi_cases, gagg_cases,
                             gmulti_cases),
                            conv_kernel_cases(f'block {t}', layout, dst, N,
                                              randn, x_grad=t > 0)):
            acc.extend(got)
        dims = {'x': layout.dim_x, 'sh': layout.dim_sh, 'w': layout.dim_w}

        # the per-edge family: each mode on random legs of every edge
        # slot; the bound counts as the JAX kernel's cost_estimate does
        # (three legs read and one written, 3 operations per scalar
        # coupling), at the live edges
        quad_flops = 3 * sum(len(p.nnz) * g.mul for g in layout.groups
                             for p in g.paths)
        for mode in ('msg', 'x', 'sh', 'w'):
            legs = [randn(E, layout.mode_dims[leg])
                    for leg in _MODE_LEGS[mode]]
            got = quad_cuda(mode, *legs, layout)
            want = quad_plain(mode, *legs, layout)
            err = compare(f'cg_quad block {t} {mode}', got, want)
            same_bits(f'cg_quad block {t} {mode}',
                      lambda: quad_cuda(mode, *legs, layout))
            width = (sum(a.shape[1] for a in legs)
                     + layout.mode_dims[_MODE_OUT[mode]])
            b_ms, b_by = bound_ms(4 * live * width, live * quad_flops)
            quad_cases.append(dict(
                shape=f'block {t} {mode}: E={E} legs '
                      f'{"/".join(str(a.shape[1]) for a in legs)}, launch '
                      f'{quad_config(layout, mode)}',
                max_abs_err=err, bit_identical=True,
                ms=cuda_ms(lambda: quad_cuda(mode, *legs, layout)),
                plain_ms=cuda_ms(lambda: quad_plain(mode, *legs, layout),
                                 iters=5),
                library_ms=None, bound_ms=b_ms, bound_by=b_by,
                device_us=device_us_per_call(
                    lambda: quad_cuda(mode, *legs, layout))))
    rows['cg_agg'] = agg_cases
    rows['cg_multi'] = multi_cases
    rows['cg_gagg'] = gagg_cases
    rows['cg_gmulti'] = gmulti_cases
    rows['cg_quad'] = quad_cases

    for name, cases in rows.items():
        for c in cases:
            lib = ('n/a' if c['library_ms'] is None
                   else f'{c["library_ms"]:.4f} ms')
            log(f'  {name} [{c["shape"]}]: kernel {c["ms"]:.4f} ms, '
                f'plain {c["plain_ms"]:.4f} ms, library {lib}, bound '
                f'{c["bound_ms"] * 1e3:.1f} us ({c["bound_by"]})')
    return rows


def phase_serve(calc, results=None, label='serve'):
    """The five requests of ft.extxyz against the serving golden, each
    with its launch census; each result is appended to ``results``."""
    import numpy as np
    import torch

    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.ops import _cuda

    structs = read_extxyz(str(FT))
    gold = np.load(GOLDEN)
    for s in structs:            # warm-up: tables and allocator
        calc.calculate(s)
    torch.cuda.synchronize()
    _cuda.LAUNCHES.clear()
    latencies = []
    for i, s in enumerate(structs):
        before = dict(_cuda.LAUNCHES)
        t0 = time.perf_counter()
        res = calc.calculate(s)
        latencies.append((time.perf_counter() - t0) * 1e3)
        if results is not None:
            results.append(res)
        got = {k: _cuda.LAUNCHES[k] - before.get(k, 0)
               for k in _cuda.KERNELS}
        if (got['cg_agg'] != 5 or got['cg_multi'] != 5
                or got['segment_sum'] < 8 or got['cg_quad'] != 0
                or any(got[k] for k in PROBES)):
            raise AssertionError(f'request {i}: launches {got}, expected '
                                 'cg_agg 5, cg_multi 5, segment_sum >= 8, '
                                 'cg_quad 0, no probe')
        e_rel = abs(res['energy'] - gold['energy'][i]) / abs(
            gold['energy'][i])
        f_ref = gold[f'forces_{i}']
        f_rel = np.abs(res['forces'] - f_ref).max() / np.abs(f_ref).max()
        s_rel = (np.abs(res['stress'] - gold['stress'][i]).max()
                 / np.abs(gold['stress'][i]).max())
        log(f'  request {i} ({len(s)} atoms): {latencies[-1]:.2f} ms, '
            f'launches {got}, energy rel {e_rel:.2e}, forces rel '
            f'{f_rel:.2e}, stress rel {s_rel:.2e}')
        if not (e_rel <= 2e-6 and f_rel <= 1e-4 and s_rel <= 1e-4):
            raise AssertionError(f'request {i} disagrees with the golden '
                                 'file')
    counts = dict(_cuda.LAUNCHES)
    log(f'[{label}] {len(structs)} requests, latency ms '
        f'{[round(x, 3) for x in latencies]}, median '
        f'{sorted(latencies)[len(latencies) // 2]:.3f} ms')
    return counts


def phase_batch(calc, batch, n_real_edge):
    import torch

    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.model.nequip import apply_model

    out = apply_model(calc.model, batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        out = apply_model(calc.model, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    for key, shape in ((K.PRED_TOTAL_ENERGY, (BATCH,)),
                       (K.PRED_FORCE, (96 * BATCH, 3)),
                       (K.PRED_STRESS, (BATCH, 6))):
        v = out[key]
        if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f'batch output {key}: shape '
                                 f'{tuple(v.shape)} or non-finite values')
    ms = sorted(times)[len(times) // 2]
    log(f'[batch] batch-8: {ms:.3f} ms per batch (median of 5), '
        f'{n_real_edge / (ms / 1e3):.1f} edges/s ({n_real_edge} real edges)')


def kernel_family(key):
    """The entry point whose kernels a device kernel's name belongs to
    (``KERNEL_FAMILIES``), or None for PyTorch's own kernels."""
    return next((fam for part, fam in KERNEL_FAMILIES if part in key), None)


def profile_device(label, fn, top=12):
    """One run of ``fn`` under torch.profiler: wall time, device busy
    share (device time / wall time) and device time by kernel, each csrc
    family summed into one row beside its census (the launches its
    wrapper counted in the same run), which its count must equal.
    Returns (wall ms, device busy ms or None)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sevennet_finetuning_tpu_torch.ops import _cuda
    from sevennet_finetuning_tpu_torch.tools.bench_dma import device_rows

    before = dict(_cuda.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    census = {k: v - before.get(k, 0) for k, v in _cuda.LAUNCHES.items()
              if v - before.get(k, 0)}
    rows = device_rows(prof)
    if not rows:
        log(f'[profile] {label}: device time not measured (the profiler '
            'recorded no device events)')
        return wall, None
    busy = sum(r[2] for r in rows)
    log(f'[profile] {label}: wall {wall:.3f} ms under the profiler, '
        f'device busy {busy:.3f} ms ({100 * busy / wall:.1f}%), '
        f'{sum(r[1] for r in rows)} device ops')
    grouped = {}                  # (family or None, key) -> [count, ms]
    for key, count, ms in rows:
        fam = kernel_family(key)
        row = grouped.setdefault((fam, fam or key), [0, 0.0])
        row[0] += count
        row[1] += ms
    profiled = {fam: c for (fam, _), (c, _) in grouped.items() if fam}
    ranked = sorted(grouped.items(), key=lambda r: -r[1][1])
    for i, ((fam, name), (count, ms)) in enumerate(ranked):
        if i < top or fam:
            log(f'  {ms:9.4f} ms {count:5d}x  '
                + (f'{fam} (csrc family; census {census.get(fam, 0)})'
                   if fam else name[:90]))
    if profiled != census:
        raise AssertionError(f'{label}: profiled launches by family '
                             f'{profiled} differ from the census {census}')
    return wall, busy


def phase_profile(calc, batch):
    """Device time by kernel for one 96-atom request and one batch-8
    forward."""
    import torch

    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.model.nequip import apply_model

    s = read_extxyz(str(FT))[0]
    runs = (('request', lambda: calc.calculate(s)),
            ('batch-8', lambda: apply_model(calc.model, batch)))
    for label, fn in runs:
        fn()
        torch.cuda.synchronize()
        profile_device(label, fn)


def new_trainer(device='cuda', dtype=None):
    """A Trainer on SevenNet-0 from the checkpoint under the reEWC recipe
    the golden files were made with (constant LR 1e-4)."""
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        load_pytree, model_from_checkpoint)
    from sevennet_finetuning_tpu_torch.train.recipe import (
        reewc_recipe_config)
    from sevennet_finetuning_tpu_torch.train.trainer import Trainer

    model, config = model_from_checkpoint(str(CKPT), device=device)
    if dtype is not None:
        model = model.to(dtype)
    return Trainer(model, reewc_recipe_config(config, FISHER, OPT_PARAMS),
                   fisher=load_pytree(str(FISHER)),
                   opt_params=load_pytree(str(OPT_PARAMS)), device=device)


def check_terms(label, got, gold, i, weights, tol, raw_tol=None,
                names=TRAIN_TERMS):
    """The step's total within tol; each weighted term within tol of the
    total; with raw_tol, each term within raw_tol of its own JAX value.
    ``names``: the total, then the terms."""
    total = abs(float(gold['Total'][i]))
    errs = {k: abs(float(got[k]) - float(gold[k][i])) * weights.get(k, 1.0)
            / total for k in names}
    worst = max(errs.values())
    # each term against its own JAX value: a small term (stress at weight
    # 0.01, EWC) carries little of the total
    raw = {k: abs(float(got[k]) / float(gold[k][i]) - 1)
           for k in names[1:]}
    raw_limit = '' if raw_tol is None else f' (limit {raw_tol:g})'
    log(f'  {label} step {i}: total {float(got["Total"]):.9e} (JAX '
        f'{float(gold["Total"][i]):.9e}), worst rel err {worst:.2e} '
        f'({max(errs, key=errs.get)}; limit {tol:g}); per term rel '
        + ', '.join(f'{k} {v:.2e}' for k, v in raw.items()) + raw_limit)
    if worst > tol:
        raise AssertionError(f'{label} step {i} loss terms disagree with '
                             f'the golden file: {errs}')
    if raw_tol is not None and max(raw.values()) > raw_tol:
        raise AssertionError(f'{label} step {i} raw loss terms disagree '
                             f'with the golden file: {raw}')
    return worst


def check_grads(label, trainer, gold, prefix='grad/'):
    """The last step's gradient of every leaf against the golden file's
    first-step gradient (keys ``prefix`` + group/leaf): within
    GRAD_TOL[label] x max|g| of the leaf (the leaves of GRAD_TOL_LEAF
    within their own limit).  Also counts elements whose sign differs
    (|g| > 1e-8 on either side)."""
    import numpy as np

    errs, flips, n, sq_err, sq = [], 0, 0, 0.0, 0.0
    for key in gold.files:
        if not key.startswith(prefix):
            continue
        g, name = key[len(prefix):].split('/')
        want = gold[key]
        got = trainer.params[g][name].grad.cpu().numpy()
        scale = max(float(np.abs(want).max()), 1e-30)
        rel = float(np.abs(got - want).max()) / scale
        tol = GRAD_TOL_LEAF.get(label, {}).get((g, name), GRAD_TOL[label])
        errs.append((rel, tol, g, name, scale))
        sq_err += float(np.sum((got.astype(np.float64) - want) ** 2))
        sq += float(np.sum(want.astype(np.float64) ** 2))
        big = (np.abs(want) > 1e-8) | (np.abs(got) > 1e-8)
        flips += int((big & (np.sign(want) != np.sign(got))).sum())
        n += want.size
    errs.sort(key=lambda e: -e[0] / e[1])
    log(f'  {label} first-step gradients of {n} parameters: relative L2 '
        f'error {(sq_err / sq) ** 0.5:.2e}; {flips} elements above 1e-8 '
        'differ in sign; worst leaves (rel err / limit):')
    for rel, tol, g, name, scale in errs[:6]:
        log(f'    {g}/{name}: {rel:.2e} / {tol:g} (max|g| {scale:.3e})')
    bad = [e for e in errs if e[0] > e[1]]
    if bad:
        raise AssertionError(f'{label} first-step gradients disagree with '
                             f'the golden file: {bad}')


def ft900_batches(trainer, gold):
    """The golden file's batches on the trainer's device: batch-8 loaders
    over the first 24 structures of ft900.extxyz and replay900.extxyz,
    unshuffled; returns (loader, memloader, train batches, memory
    batches)."""
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.data.dataset import (
        GraphDataset, Loader)
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz

    spec = trainer.spec
    tm = dict(spec.type_map)
    loader = Loader(GraphDataset.from_structures(
        read_extxyz(str(FT900))[:24], spec.cutoff, tm), BATCH)
    memloader = Loader(GraphDataset.from_structures(
        read_extxyz(str(REPLAY900))[:24], spec.cutoff, tm), BATCH)
    if loader.n_edge != int(gold['n_edge_slots']):
        raise AssertionError(f'edge slots {loader.n_edge} != golden '
                             f'{int(gold["n_edge_slots"])}')
    tb = [trainer.place_batch(b) for b in loader]
    mb = [trainer.place_batch(b) for b in memloader]
    real = [int(b[K.EDGE_MASK].sum()) for pair in zip(tb, mb) for b in pair]
    if real != [int(v) for v in gold['real_edges']]:
        raise AssertionError(f'real edges {real} != golden '
                             f'{list(gold["real_edges"])}')
    return loader, memloader, tb, mb


def step_census(trainer, batch, acc):
    """One train step with the launch counts set to 0 just before it and
    read just after, and the (E, D, n_rows) of each segment_sum launch;
    returns (acc, terms, counts, ms)."""
    from collections import Counter

    import torch

    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.ops import _cuda, scatter

    shapes = Counter()
    launch = scatter.segment_sum_cuda

    def recorded(msg, dst, n_rows):
        shapes[(msg.shape[0], msg.shape[1], n_rows)] += 1
        return launch(msg, dst, n_rows)

    torch.cuda.synchronize()
    _cuda.LAUNCHES.clear()
    scatter.segment_sum_cuda = recorded
    try:
        t0 = time.perf_counter()
        acc, terms = trainer.train_step(batch, acc)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        scatter.segment_sum_cuda = launch
    counts = {k: _cuda.LAUNCHES[k] for k in _cuda.KERNELS}
    if counts != TRAIN_CENSUS:
        raise AssertionError(f'train step launches {counts}, expected '
                             f'{TRAIN_CENSUS}')
    want = train_segment_shapes(batch[K.EDGE_IDX].shape[1],
                                batch[K.POS].shape[0],
                                batch[K.CELL].shape[0])
    if shapes != want:
        raise AssertionError(f'train step segment_sum shapes '
                             f'{dict(shapes)}, expected {want}')
    return acc, terms, counts, ms


def phase_train():
    """The reEWC train step at full width against the JAX-CPU goldens;
    returns the launch counts of one train step."""
    import numpy as np
    import torch

    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.data.dataset import (
        GraphDataset, Loader)
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.model.nequip import apply_model
    from sevennet_finetuning_tpu_torch.ops import _cuda
    from sevennet_finetuning_tpu_torch.train.metrics import init_accumulators

    # --- 2 steps on the 12-atom structure: terms and first-step grads ---
    trainer = new_trainer()
    spec = trainer.spec
    tm = dict(spec.type_map)
    weights = {ls.name: ls.weight for ls in trainer.loss_specs}
    gold = np.load(GOLDEN_FT12)
    s12 = [s for s in read_extxyz(str(FT)) if len(s) == 12]
    b12 = trainer.place_batch(next(iter(Loader(
        GraphDataset.from_structures(s12, spec.cutoff, tm), 1))))
    acc = init_accumulators(trainer.metric_specs, trainer.device)
    for i in range(2):
        acc, terms, _, _ = step_census(trainer, b12, acc)
        check_terms('ft12', terms, gold, i, weights, STEP0_TOL)
        if i == 0:
            check_grads('ft12', trainer, gold)

    # --- 3 rehearsal iterations at batch 8 ---
    gold = np.load(GOLDEN_FT900)
    trainer = new_trainer()
    loader, memloader, tb, mb = ft900_batches(trainer, gold)
    order = [b for pair in zip(tb, mb) for b in pair]
    real = [int(b[K.EDGE_MASK].sum()) for b in order]
    # every batch's loss at the checkpoint's parameters
    for i, b in enumerate(order):
        out = apply_model(trainer.model, b)
        with torch.no_grad():
            total, terms = trainer.loss_fn(trainer.params, out)
        check_terms('ft900 eval', dict(terms, Total=total),
                    {k: gold[f'eval/{k}'] for k in TRAIN_TERMS}, i, weights,
                    STEP0_TOL, RAW_TERM_TOL)
    accs = [init_accumulators(trainer.metric_specs, trainer.device)
            for _ in range(2)]
    for i, b in enumerate(order):
        accs[i % 2], terms, counts, _ = step_census(trainer, b, accs[i % 2])
        if i == 0:
            check_terms('ft900', terms, gold, i, weights, STEP0_TOL,
                        RAW_TERM_TOL)
        else:
            check_terms('ft900', terms, gold, i, weights, TRAJ_TOL)
        if i == 0:
            check_grads('ft900', trainer, gold)
            shapes = train_segment_shapes(b[K.EDGE_IDX].shape[1],
                                          b[K.POS].shape[0],
                                          b[K.CELL].shape[0])
            log(f'  segment_sum launches per train step by (E, D, n_rows): '
                f'{shapes} (asserted every step)')
    step_metrics = trainer._finalize(*accs)

    # the user's entry point: one rehearsal epoch from a fresh trainer
    # gives the same steps on the same device: its metrics equal the step
    # loop's (the kernels are deterministic); the JAX epoch metrics are
    # printed beside them
    trainer_b = new_trainer()
    torch.cuda.synchronize()
    _cuda.LAUNCHES.clear()
    train_m, mem_m = trainer_b.run_one_epoch_rehearsal(loader, memloader)
    torch.cuda.synchronize()
    epoch_counts = {k: _cuda.LAUNCHES[k] for k in _cuda.KERNELS}
    want_counts = {k: 2 * len(tb) * v for k, v in TRAIN_CENSUS.items()}
    if epoch_counts != want_counts:
        raise AssertionError(f'rehearsal epoch launches {epoch_counts}, '
                             f'expected {want_counts}')
    for kind, got, loop in (('train', train_m, step_metrics[0]),
                            ('mem', mem_m, step_metrics[1])):
        for key, v in got.items():
            want = float(gold[f'{kind}/{key}'])
            log(f'  rehearsal epoch {kind} {key}: {v:.9e} (step loop '
                f'{loop[key]:.9e}; JAX {want:.9e}, rel '
                f'{abs(v - want) / abs(want):.2e})')
            if abs(v - loop[key]) > 1e-6 * abs(loop[key]):
                raise AssertionError(f'rehearsal epoch {kind} {key} differs '
                                     'from the same steps taken one by one')

    # --- timing: more rehearsal iterations on the same batches ---
    step_ms, iter_ms, peaks = [], [], []
    for _ in range(3):
        for t, m in zip(tb, mb):
            pair = 0.0
            for b in (t, m):
                torch.cuda.reset_peak_memory_stats()
                accs[0], _, _, ms = step_census(trainer, b, accs[0])
                peaks.append(torch.cuda.max_memory_allocated())
                step_ms.append(ms)
                pair += ms
            iter_ms.append(pair)
    med_step = sorted(step_ms)[len(step_ms) // 2]
    med_iter = sorted(iter_ms)[len(iter_ms) // 2]
    log(f'[train] batch 8, {loader.n_edge} edge slots, real edges per step '
        f'{real}: median {med_step:.3f} ms per train step, {med_iter:.3f} ms '
        f'per rehearsal iteration (train + memory step), '
        f'{3 * sum(real) / sum(step_ms) * 1e3:.1f} edges/s over '
        f'{len(step_ms)} timed steps; peak memory '
        f'{max(peaks) / 2**30:.3f} GiB')

    # --- profile: one rehearsal iteration ---
    def iteration():
        for b in (tb[0], mb[0]):
            accs[0], _ = trainer.train_step(b, accs[0])

    profile_device('rehearsal iteration', iteration, top=14)
    return counts


def _stage_floors(path):
    """The float32 floor of each error metric's quantity on one data file
    (energy per atom in eV, forces in eV/A, stress in kbar): the serving
    limits of PERF.md section 2 at the file's values."""
    import numpy as np

    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.train.loss import TO_KBAR

    structs = read_extxyz(str(path))
    e = np.mean([abs(s.energy) / len(s) for s in structs])
    f = max(float(np.abs(s.forces).max()) for s in structs)
    st = max(float(np.abs(s.stress).max()) for s in structs)
    return {'Energy': GOLDEN_ENERGY_TOL * e, 'Force': 1e-4 * f,
            'Stress': 1e-4 * st * TO_KBAR}


def check_csv(path, gold, floors):
    """log.csv of the fine-tune stage against the golden file's, value by
    value (epoch and lr equal; limits of PIPELINE_*_TOL)."""
    import csv

    with open(path) as f:
        rows = list(csv.DictReader(f))
    cols = [k[4:] for k in gold.files if k.startswith('csv/')]
    if not rows or list(rows[0]) != cols:
        raise AssertionError(f'log.csv columns {list(rows[0]) if rows else []}'
                             f' != golden {cols}')
    if len(rows) != len(gold['csv/epoch']):
        raise AssertionError(f'log.csv has {len(rows)} rows, golden '
                             f'{len(gold["csv/epoch"])}')
    worst = {}
    for i, row in enumerate(rows):
        for col in cols:
            got, want = float(row[col]), float(gold[f'csv/{col}'][i])
            if col in ('epoch', 'lr'):
                if got != want:
                    raise AssertionError(f'log.csv row {i} {col}: {got} != '
                                         f'{want}')
                continue
            tol = (PIPELINE_EPOCH1_TOL if i == 0 and col.startswith('train_')
                   else PIPELINE_LATER_TOL)
            floor = next((v for k, v in floors.items()
                          if col.split('_')[1] == k), 0.0)
            limit = tol * abs(want) + floor
            share = abs(got - want) / limit if limit else float(got != want)
            if share > worst.get(col, (0,))[0]:
                worst[col] = (share, i, got, want, limit)
            if share > 1:
                raise AssertionError(f'log.csv row {i} {col}: {got!r} vs JAX '
                                     f'{want!r}, limit {limit:.3e}')
    for col, (share, i, got, want, limit) in sorted(worst.items()):
        log(f'  log.csv {col}: worst at row {i}: {got:.9e} vs JAX '
            f'{want:.9e} ({share:.2f} of the limit {limit:.3e})')


def phase_pipeline(tmp):
    """The train CLI of the port on the card: the two stages of
    ``recipe.pipeline_stages`` (a Fisher stage with -fs, then a 3-epoch
    reEWC fine-tune with rehearsal consuming its artifacts) through
    ``main.main`` into the directory ``tmp`` (the compat phase reruns the
    fine-tune from its Fisher artifacts and compares with its log.csv),
    held against ``golden/pipeline_ft_jax_cpu.npz``; returns the launch
    counts of the two stages."""
    import hashlib
    import re

    import numpy as np
    import torch
    import yaml

    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.main import main as cli
    from sevennet_finetuning_tpu_torch.ops import _cuda
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        load_checkpoint, load_pytree)
    from sevennet_finetuning_tpu_torch.train.recipe import pipeline_stages

    gold = np.load(GOLDEN_PIPELINE)
    tmp = Path(tmp)
    fisher_dir, ft_dir = tmp / 'fisher_out', tmp / 'ft_out'
    stages = pipeline_stages(ROOT, str(fisher_dir))
    torch.cuda.synchronize()
    _cuda.LAUNCHES.clear()
    walls = {}
    for name, cfg, wd, extra in zip(('fisher', 'ft'), stages,
                                    (fisher_dir, ft_dir),
                                    (['-fs'], [])):
        path = tmp / f'{name}_input.yaml'
        path.write_text(yaml.safe_dump(cfg))
        t0 = time.perf_counter()
        cli(['train', str(path), '-w', str(wd)] + extra)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
    counts = {k: _cuda.LAUNCHES[k] for k in _cuda.KERNELS}

    # stage 1: the anchor bit for bit, the Fisher leaf by leaf
    fisher = load_pytree(str(fisher_dir / 'fisher_sevenn.pt'))
    anchor = load_pytree(str(fisher_dir / 'opt_params_sevenn.pt'))
    worst = []
    for g, names in fisher.items():
        for n, got in names.items():
            a = np.ascontiguousarray(anchor[g][n], np.float32)
            if hashlib.sha256(a.tobytes()).hexdigest() != str(
                    gold[f'opt_params_sha256/{g}/{n}']):
                raise AssertionError(f'opt_params {g}/{n} differs from '
                                     'the JAX anchor')
            want_f = gold[f'fisher/{g}/{n}']
            scale = max(float(np.abs(want_f).max()), 1e-30)
            rel = float(np.abs(got - want_f).max()) / scale
            tol = PIPELINE_FISHER_TOL_LEAF.get((g, n), PIPELINE_FISHER_TOL)
            worst.append((rel / tol, rel, tol, f'{g}/{n}', scale))
    worst.sort(reverse=True)
    log(f'  opt_params: {len(worst)} leaves bit-equal to JAX; Fisher '
        'leaves, worst (rel err / limit, max|F|):')
    for share, rel, tol, key, scale in worst[:5]:
        log(f'    {key}: {rel:.2e} / {tol:g} ({scale:.3e})')
    if worst[0][0] > 1:
        raise AssertionError(f'Fisher leaves disagree with the golden '
                             f'file: {worst[:5]}')

    # stage 2: log.csv, the checkpoints, the best one served
    floors = _stage_floors(FT)
    for k, v in _stage_floors(REPLAY).items():  # the memory columns
        floors[k] = max(floors[k], v)
    check_csv(ft_dir / 'log.csv', gold, floors)
    names = sorted(p.name for p in ft_dir.glob('checkpoint_*.pth'))
    if names != [str(x) for x in gold['checkpoints']]:
        raise AssertionError(f'checkpoints {names} != golden '
                             f'{list(gold["checkpoints"])}')
    text = (ft_dir / 'log.sevenn').read_text()
    epoch_s = [float(x) for x in re.findall(r'epoch time: ([0-9.]+) s',
                                            text)]
    best = load_checkpoint(str(ft_dir / 'checkpoint_best.pth'))
    calc = Calculator.from_checkpoint(str(ft_dir / 'checkpoint_best.pth'),
                                      device='cuda')
    errs = []
    for s in read_extxyz(str(FT)):
        res = calc.calculate(s)
        if not (np.isfinite(res['energy'])
                and res['forces'].shape == (len(s), 3)
                and np.isfinite(res['forces']).all()
                and res['stress'].shape == (6,)):
            raise AssertionError('checkpoint_best.pth serves non-finite '
                                 'or misshapen results')
        errs.append(abs(res['energy'] - s.energy) / len(s))
    log(f'  checkpoint_best.pth (epoch {best["epoch"]}) served ft.extxyz:'
        f' |E - label| per atom {[f"{e:.2e}" for e in errs]} eV')
    if max(errs) > 1e-2:
        raise AssertionError('checkpoint_best.pth does not fit its own '
                             f'training data: {errs}')

    # where a stage's wall time goes: each stage once more under the
    # profiler (into other directories, after the counts were read)
    for name, extra in (('fisher', ['-fs']), ('ft', [])):
        profile_device(f'{name} stage', lambda: cli(
            ['train', str(tmp / f'{name}_input.yaml'), '-w',
             str(tmp / f'{name}_profiled')] + extra), top=8)
    # the launches: a Fisher sample and a train step run the same
    # kernels (TRAIN_CENSUS), a valid batch those of a request
    n_fisher = 5 - int(5 * 0.2)           # replay.extxyz's train split
    n_steps = 3 * 2                       # 3 epochs x (train + memory)
    n_eval = 3                            # one valid batch an epoch
    eval_census = {'cg_agg': 5, 'cg_multi': 5, 'cg_gagg': 0,
                   'cg_gmulti': 0, 'cg_quad': 0}
    want = {k: (n_fisher + n_steps) * TRAIN_CENSUS[k]
            + n_eval * eval_census.get(k, 0) for k in eval_census}
    log(f'[pipeline] launches of the two stages {counts}; expected '
        f'{want} and segment_sum >= '
        f'{(n_fisher + n_steps) * TRAIN_CENSUS["segment_sum"]}')
    if any(counts[k] != v for k, v in want.items()) or any(
            counts[k] for k in PROBES) or counts['segment_sum'] < (
            n_fisher + n_steps) * TRAIN_CENSUS['segment_sum']:
        raise AssertionError(f'pipeline launches {counts}, expected '
                             f'{want}')

    log(f'[pipeline] Fisher stage {walls["fisher"]:.3f} s wall ({n_fisher} '
        f'samples), fine-tune stage {walls["ft"]:.3f} s wall; epoch time '
        f'(log.sevenn, ms) {[round(x * 1e3) for x in epoch_s]}')
    return counts


def permute_edges(batch, perm):
    """The batch with its edge slots in the order ``perm`` (dst no longer
    ascending); the src-sort permutation no longer applies and is
    dropped, so run_blocks sorts src itself."""
    import torch

    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.model.nequip import EDGE_SRC_INV_PERM

    p = torch.as_tensor(perm, device=batch[K.EDGE_IDX].device)
    out = {k: v for k, v in batch.items()
           if k not in (K.EDGE_SRC_PERM, EDGE_SRC_INV_PERM)}
    out[K.EDGE_IDX] = batch[K.EDGE_IDX][:, p].contiguous()
    out[K.CELL_SHIFT] = batch[K.CELL_SHIFT][p]
    out[K.EDGE_MASK] = batch[K.EDGE_MASK][p]
    return out


def unsorted_energy(model, data, edge_vec):
    """Energies per graph and the last block's node features through the
    public ``run_blocks(edges_sorted=False)``, with energy_network's steps
    around it."""
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.model.nequip import (
        embed_edges, embed_nodes, graph_energy, run_blocks)

    spec, p = model.spec, model.params
    idx = data[K.EDGE_IDX]
    _, emb, attr = embed_edges(spec, p, edge_vec, data[K.EDGE_MASK])
    onehot, x = embed_nodes(spec, p, data[K.ATOM_TYPE], edge_vec.dtype)
    x = run_blocks(spec, p, x, onehot, emb, attr, idx[1], idx[0],
                   data[K.POS].shape[0], edges_sorted=False)
    return graph_energy(spec, p, x, data)[2], x


def sorted_energy(model, data, edge_vec):
    """The same through ``energy_network`` (dst-sorted collate batches)."""
    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.model.nequip import energy_network

    out = energy_network(model, data, edge_vec)
    return out[K.PRED_TOTAL_ENERGY], out[K.NODE_FEATURE]


def force_pass(energy_fn, model, data, weights=None):
    """(energies, node features, fij = dE/d edge_vec, grads).  With
    ``weights`` [E, 3], fij keeps its graph (create_graph=True) and grads
    maps every parameter leaf to the gradient of sum(weights * fij)
    (zeros for a leaf it does not reach); else grads is None."""
    import torch

    from sevennet_finetuning_tpu_torch.model.nequip import compute_edge_vec

    edge_vec = compute_edge_vec(data).detach().requires_grad_(True)
    energy, x = energy_fn(model, data, edge_vec)
    fij, = torch.autograd.grad(energy.sum(), edge_vec,
                               create_graph=weights is not None)
    grads = None
    if weights is not None:
        leaves = [(f'{g}/{n}', prm) for g, names in model.params.items()
                  for n, prm in names.items()]
        gs = torch.autograd.grad((fij * weights).sum(),
                                 [prm for _, prm in leaves],
                                 allow_unused=True)
        grads = {name: torch.zeros_like(prm) if g is None else g
                 for (name, prm), g in zip(leaves, gs)}
    return energy.detach(), x.detach(), fij.detach(), grads


def _max_rel(got, want):
    """max|got - want| / max|want| (tensors or numpy arrays)."""
    import torch

    got, want = torch.as_tensor(got), torch.as_tensor(want)
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def phase_unsorted(batch):
    """SevenNet-0 on the batch-8 collate with every edge slot permuted,
    through run_blocks(edges_sorted=False): against the JAX-CPU golden
    file and the sorted path on the same graph; launch census; times."""
    import numpy as np
    import torch

    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.ops import _cuda
    from sevennet_finetuning_tpu_torch.ops.fused_conv_kernel import (
        MODE_LAUNCHES)
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        model_from_checkpoint)

    gold = np.load(GOLDEN_UNSORTED)
    E = batch[K.EDGE_IDX].shape[1]
    perm = np.random.default_rng(int(gold['perm_seed'])).permutation(E)
    if (E != int(gold['n_edge_slots'])
            or not np.array_equal(perm, gold['perm'])
            or not np.array_equal(batch[K.ATOM_TYPE].cpu().numpy(),
                                  gold['atom_type'])):
        raise AssertionError('the batch or its permutation differs from the '
                             'golden file\'s')
    model, _ = model_from_checkpoint(str(CKPT), device='cuda')
    dev = batch[K.EDGE_IDX].device
    data = permute_edges(batch, perm)
    pt = torch.as_tensor(perm, device=dev)
    weights = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (E, 3)).astype(np.float32), device=dev)

    force_pass(unsorted_energy, model, data, weights[pt])   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.LAUNCHES.clear()
    MODE_LAUNCHES.clear()
    e_u, x_u, f_u, g_u = force_pass(unsorted_energy, model, data,
                                    weights[pt])
    torch.cuda.synchronize()
    counts = {k: _cuda.LAUNCHES[k] for k in _cuda.KERNELS}
    modes = dict(MODE_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f'[unsorted] one pass (forward, fij with create_graph, parameter '
        f'gradient): launches {counts}, cg_quad by mode {modes}; peak '
        f'memory {peak / 2**30:.3f} GiB')
    if counts != UNSORTED_CENSUS or modes != UNSORTED_MODES:
        raise AssertionError(f'unsorted pass launches {counts} {modes}, '
                             f'expected {UNSORTED_CENSUS} {UNSORTED_MODES}')

    # against the JAX-CPU golden file (same permuted graph)
    g_e = torch.as_tensor(gold['energy'], device=dev)
    e_rel = float(((e_u.double() - g_e).abs() / g_e.abs()).max())
    f_rel = _max_rel(f_u, torch.as_tensor(gold['fij'], device=dev))
    x_rel = _max_rel(x_u, torch.as_tensor(gold['features'], device=dev))
    log(f'  vs JAX golden: energy rel {e_rel:.2e} (limit '
        f'{GOLDEN_ENERGY_TOL:g}), fij max-abs rel {f_rel:.2e} (limit '
        f'{GOLDEN_FIJ_TOL:g}), features max-abs rel {x_rel:.2e}')
    if e_rel > GOLDEN_ENERGY_TOL or f_rel > GOLDEN_FIJ_TOL:
        raise AssertionError('the unsorted path disagrees with the golden '
                             'file')

    # against the sorted path on the same graph, fij un-permuted
    e_s, x_s, f_s, g_s = force_pass(sorted_energy, model, batch, weights)
    x_err = _max_rel(x_u, x_s)
    f_err = _max_rel(f_u, f_s[pt])
    g_errs = []
    for k in g_s:
        scale = float(g_s[k].abs().max())
        err = (_max_rel(g_u[k], g_s[k]) if scale > 0
               else float(g_u[k].abs().max()))
        tol = (UNSORTED_DENOMINATOR_TOL if k.endswith('_convolution/'
                                                      'denominator')
               else UNSORTED_GRAD_TOL)
        g_errs.append((err / tol, err, tol, k, scale))
    g_errs.sort(reverse=True)
    log(f'  vs sorted path: energy rel '
        f'{float(((e_u - e_s).abs() / e_s.abs()).max()):.2e}, features '
        f'{x_err:.2e} (limit {UNSORTED_FEATURE_TOL:g}), fij {f_err:.2e} '
        f'(limit {UNSORTED_FIJ_TOL:g}); parameter gradients of '
        f'{len(g_s)} leaves, worst (rel err / limit, max|g|): '
        + ', '.join(f'{k} {e:.2e} / {t:g} ({sc:.3e})'
                    for _, e, t, k, sc in g_errs[:5]))
    if (x_err > UNSORTED_FEATURE_TOL or f_err > UNSORTED_FIJ_TOL
            or g_errs[0][0] > 1.0):
        raise AssertionError('the unsorted path disagrees with the sorted '
                             'path')

    # serving-style forward + fij, unsorted and sorted in turns
    times = {'unsorted': [], 'sorted': []}
    runs = (('unsorted', unsorted_energy, data),
            ('sorted', sorted_energy, batch))
    for _ in range(5):
        for label, fn, d in runs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            force_pass(fn, model, d)
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - t0) * 1e3)
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    log(f'[unsorted] batch 8, {E} edge slots: forward + fij median of 5 '
        f'{med["unsorted"]:.3f} ms unsorted, {med["sorted"]:.3f} ms sorted '
        f'(same run, in turns)')
    profile_device('unsorted forward + fij',
                   lambda: force_pass(unsorted_energy, model, data))
    # the whole pass of the census: forward, fij with create_graph and
    # the parameter gradient (cg_quad 77 launches)
    profile_device('unsorted whole pass (forward, fij with create_graph, '
                   'parameter gradient)',
                   lambda: force_pass(unsorted_energy, model, data,
                                      weights[pt]))
    return counts


@contextlib.contextmanager
def neighbor_builder(name):
    """The port's neighbor list inside the block: 'native' (the compiled
    core, its default) or 'ckdtree' (scipy), through the SEVENN_NO_NATIVE
    switch of ``data/neighborlist.py``; the switch is restored after."""
    old = os.environ.pop('SEVENN_NO_NATIVE', None)
    if name == 'ckdtree':
        os.environ['SEVENN_NO_NATIVE'] = '1'
    try:
        yield
    finally:
        os.environ.pop('SEVENN_NO_NATIVE', None)
        if old is not None:
            os.environ['SEVENN_NO_NATIVE'] = old


def _shape_key(a):
    """A launch argument as it enters a capture key: a tensor by its
    shape, a list of tensors (a pool) by their shapes, a hashable option
    by its value, anything else by identity."""
    import torch

    if isinstance(a, torch.Tensor):
        return tuple(a.shape)
    if isinstance(a, list) and all(isinstance(t, torch.Tensor) for t in a):
        return tuple(tuple(t.shape) for t in a)
    try:
        hash(a)
    except TypeError:
        return id(a)
    return a


def _kept(a):
    """A launch argument as a capture keeps it: tensors detached."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.detach()
    if isinstance(a, list):
        return [_kept(t) for t in a]
    return a


class KernelCapture:
    """While active, the wrappers of ``kernels`` (by default
    ``segment_sum``, ``cg_agg`` and ``cg_multi``; ``cg_gagg`` and
    ``cg_gmulti`` on request) launch as usual (and count), and the first
    call at each
    distinct shape (the argument shapes and the options) keeps its card
    tensors and result; ``check`` then holds every kept result against
    the kernel's plain version on the same tensors and lets the tensors
    go.  A shape checked once is not kept again, so every distinct shape
    launched while the capture is active is checked exactly once; leaving
    it with a kept launch unchecked fails."""

    def __init__(self, kernels=('segment_sum', 'cg_agg', 'cg_multi')):
        self.kernels = kernels
        self.records = {}
        self.checked = set()
        self.worst = {}               # check label -> {kernel: max_abs_err}

    def __enter__(self):
        from sevennet_finetuning_tpu_torch.ops import fused_conv_agg as A
        from sevennet_finetuning_tpu_torch.ops import fused_conv_multi as M
        from sevennet_finetuning_tpu_torch.ops import scatter as S

        self.patched = [
            p for p in ((S, 'segment_sum_cuda', 'segment_sum',
                         S.segment_sum_plain),
                        (A, 'agg_cuda', 'cg_agg', A.agg_plain),
                        (M, 'multi_cuda', 'cg_multi', M.multi_plain),
                        (M, 'gagg_cuda', 'cg_gagg', M.gagg_plain),
                        (M, 'gmulti_cuda', 'cg_gmulti', M.gmulti_plain))
            if p[2] in self.kernels]
        self.originals = [getattr(mod, attr)
                          for mod, attr, _, _ in self.patched]
        for (mod, attr, name, _), orig in zip(self.patched, self.originals):
            setattr(mod, attr, self._wrap(name, orig))
        return self

    def __exit__(self, exc_type, *exc):
        for (mod, attr, _, _), orig in zip(self.patched, self.originals):
            setattr(mod, attr, orig)
        if exc_type is None and self.records:
            raise AssertionError(f'{len(self.records)} kernel launches kept '
                                 'and never checked')

    def _wrap(self, name, orig):
        def fn(*args):
            out = orig(*args)
            key = (name,) + tuple(_shape_key(a) for a in args)
            if key not in self.records and key not in self.checked:
                kept = (tuple(o.detach().clone() for o in out)
                        if isinstance(out, tuple) else out.detach().clone())
                self.records[key] = (tuple(_kept(a) for a in args), kept)
            return out

        return fn

    def check(self, label):
        """Each launch kept since the last check against its plain
        version: ``cg_agg``, ``cg_multi``, ``cg_gagg`` and ``cg_gmulti`` on
        the same card tensors within KERNEL_TOL; ``segment_sum`` bit for bit against its plain
        version on the host CPU, which adds each row's edges in edge order
        as the kernel does (on the card the plain version's ``index_add_``
        adds in the order its atomics land: 2.3e-6 of max off the kernel
        over the 58,880 edges of the 768-atom virial).  Returns {kernel:
        largest max_abs_err} over the shapes first seen since the last
        check, kept under ``label`` in ``worst``."""
        plains = {name: plain for _, _, name, plain in self.patched}
        worst = {}
        for key, (args, got) in self.records.items():
            name = key[0]
            if name == 'segment_sum':
                msg, dst, n = args
                err = compare(f'{label} {name} {tuple(msg.shape)} -> {n}',
                              got.cpu(), plains[name](msg.cpu(), dst.cpu(),
                                                      n), 0.0)
            else:
                err = compare(f'{label} {name} {key[1]}', got,
                              plains[name](*args))
            worst[name] = max(worst.get(name, 0.0), err)
        log(f'  {label}: {len(self.records)} new kernel shapes checked '
            f'against their plain versions, {len(self.checked)} before')
        self.checked.update(self.records)
        self.records.clear()
        if worst:
            self.worst[label] = worst


def md_census(label, got, n_evals, d3, per_eval=MD_CENSUS):
    """The launches of ``n_evals`` force evaluations: agg 5 and multi 5
    each, at least 8 segment sums each (13 with D3), nothing else
    (``per_eval``: the counts of one evaluation without D3, segment sums
    as the least)."""
    want = {k: v * n_evals for k, v in per_eval.items()
            if k != 'segment_sum'}
    min_seg = (per_eval['segment_sum']
               + (D3_SEGMENT_SUMS if d3 else 0)) * n_evals
    others = {k: v for k, v in got.items()
              if v and k not in ('cg_agg', 'cg_multi', 'segment_sum')}
    if (any(got.get(k, 0) != v for k, v in want.items())
            or got.get('segment_sum', 0) < min_seg or others):
        raise AssertionError(f'{label}: launches {got}, expected {want} '
                             f'and segment_sum >= {min_seg} over {n_evals} '
                             'force evaluations, nothing else')


def _launch_diff(before):
    from sevennet_finetuning_tpu_torch.ops import _cuda

    return {k: _cuda.LAUNCHES[k] - before.get(k, 0) for k in _cuda.KERNELS
            if _cuda.LAUNCHES[k] - before.get(k, 0)}


def check_served(label, res, energy, forces, stress, e_tol=GOLDEN_ENERGY_TOL,
                 f_tol=GOLDEN_FIJ_TOL):
    e_rel = abs(res['energy'] - energy) / abs(energy)
    f_rel = _max_rel(res['forces'], forces)
    s_rel = _max_rel(res['stress'], stress)
    log(f'  {label}: energy rel {e_rel:.2e}, forces rel {f_rel:.2e}, '
        f'stress rel {s_rel:.2e}')
    if not (e_rel <= e_tol and f_rel <= f_tol and s_rel <= f_tol):
        raise AssertionError(f'{label} disagrees with the golden file')


def check_md_golden(label, vv, gold, tag):
    """A device-loop run from the golden start against the golden's: the
    steps per segment, E_pot and E_kin each step, the final positions and
    velocities."""
    import numpy as np

    done = list(vv.result.segments)
    want_done = [int(x) for x in gold[f'{tag}_done']]
    epot = np.array(vv.result.energies)
    e_rel = float(np.max(np.abs(epot - gold[f'{tag}_epot'])
                         / np.abs(gold[f'{tag}_epot'])))
    k_rel = float(np.max(np.abs(np.array(vv.result.kinetic)
                                - gold[f'{tag}_ekin'])
                         / np.abs(gold[f'{tag}_ekin'])))
    pos_err = float(np.abs(vv.s.pos - gold[f'{tag}_pos']).max())
    vel_gold = gold[f'{tag}_vel']
    vel_err = float(np.abs(vv.vel - vel_gold).max())
    # the largest |dv| over its limit (1 or less holds)
    vel_share = float(np.max(np.abs(vv.vel - vel_gold)
                             / (MD_VEL_ATOL + MD_VEL_RTOL * np.abs(vel_gold))))
    log(f'  {label}: steps per segment {done} (golden {want_done}), E_pot '
        f'rel {e_rel:.2e} (limit {MD_EPOT_TOL:g}), positions max-abs '
        f'{pos_err:.2e} A (limit {MD_POS_TOL:g}), E_kin rel {k_rel:.2e} '
        f'(limit {MD_EKIN_TOL:g}), velocities max-abs {vel_err:.2e} A/fs '
        f'({vel_share:.2e} of the limit {MD_VEL_ATOL:g} + {MD_VEL_RTOL:g} '
        f'|v|)')
    if done != want_done:
        raise AssertionError(f'{label}: steps per segment {done}, golden '
                             f'{want_done}')
    if not (e_rel <= MD_EPOT_TOL and pos_err <= MD_POS_TOL
            and k_rel <= MD_EKIN_TOL and vel_share <= 1.0):
        raise AssertionError(f'{label} disagrees with the golden file')


def timed_md(label, fn, n_steps, results):
    """Host clock around ``fn`` (n_steps MD steps) to a device sync; peak
    memory over it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_steps
    peak = torch.cuda.max_memory_allocated() / 2**30
    results[label] = dict(ms_per_step=round(ms, 3),
                          steps_per_s=round(1e3 / ms, 3),
                          peak_gib=round(peak, 3), steps=n_steps)
    log(f'  [time] {label}: {ms:.3f} ms per step, {1e3 / ms:.2f} steps/s '
        f'over {n_steps} steps, peak memory {peak:.3f} GiB')


def md_768_d3(big, new_md, calc_d3, cap, times):
    """The 768-atom runs with D3 (~5.7 million D3 pairs): first, untimed,
    the host loop's first force evaluation (``calc_d3.calculate`` at the
    start positions) and a 2-step segment of the device loop, their kernel
    launches held against their plain versions; then both loops timed,
    their energies finite."""
    import numpy as np

    calc_d3.calculate(big)
    new_md(big).run_device(2, seg_steps=MD['seg_steps'])
    cap.check('md 768-atom D3 step')
    vv = new_md(big)
    timed_md('768 d3 run_device', lambda: vv.run_device(
        MD_TIMED_STEPS['768 d3'], seg_steps=MD['seg_steps']),
        MD_TIMED_STEPS['768 d3'], times)
    host = new_md(big)
    timed_md('768 d3 run', lambda: host.run(MD_TIMED_RUN_STEPS['768 d3']),
             MD_TIMED_RUN_STEPS['768 d3'], times)
    for label, v in (('768 d3 run_device', vv), ('768 d3 run', host)):
        if not np.isfinite(v.result.total).all():
            raise AssertionError(f'{label}: non-finite energies')
    cap.check('md 768-atom D3 timed runs')


def phase_md():
    """Molecular dynamics on the card at SevenNet-0's full width: deploy
    the checkpoint (``main get_model``), serve ft.extxyz from the
    artifact and through ``main inference``, D3 terms, the device and
    host MD loops at 96 and 768 atoms with and without D3, the FCTP
    model; every distinct shape at which the phase launches a kernel is
    held against the kernel's plain version (``KernelCapture``).  The
    native neighbor list, as the MD and serving goldens were made.
    Returns the launch counts of the phase."""
    with neighbor_builder('native'), KernelCapture() as cap:
        return _md_runs(cap)


def _md_runs(cap):
    import csv
    import os
    import tempfile

    import numpy as np
    import torch

    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.compat.known_models import (
        EXAMPLE_MD_MODEL)
    from sevennet_finetuning_tpu_torch.data.native import native_available
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.data.vasp import replicate
    from sevennet_finetuning_tpu_torch.main import main as cli
    from sevennet_finetuning_tpu_torch.md import VelocityVerlet
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec
    from sevennet_finetuning_tpu_torch.model.nequip import init_params
    from sevennet_finetuning_tpu_torch.ops import _cuda
    from sevennet_finetuning_tpu_torch.train.checkpoint import load_deployed

    t_phase = time.perf_counter()
    log(f'[md] neighbor list: '
        f'{"native" if native_available() else "cKDTree (no g++)"}')
    gold = np.load(GOLDEN_MD)
    serve_gold = np.load(GOLDEN)
    structs = read_extxyz(str(FT))
    s0 = read_extxyz(str(FT900))[0]
    times = {}
    _cuda.LAUNCHES.clear()
    with tempfile.TemporaryDirectory() as tmp:
        art = os.path.join(tmp, 'deployed_serial.sevenn')
        cli(['get_model', str(CKPT), '-o', art])
        calc = Calculator.from_deployed(art, device='cuda')
        calc.calculate(structs[0])                    # warm-up
        for i, s in enumerate(structs):
            before = dict(_cuda.LAUNCHES)
            res = calc.calculate(s)
            md_census(f'deployed request {i}', _launch_diff(before), 1,
                      False)
            check_served(f'deployed request {i} ({len(s)} atoms)', res,
                         serve_gold['energy'][i], serve_gold[f'forces_{i}'],
                         serve_gold['stress'][i])
        out_dir = os.path.join(tmp, 'inference')
        t0 = time.perf_counter()
        cli(['inference', art, str(FT), '-o', out_dir, '-b', '5'])
        log(f'  main inference: {time.perf_counter() - t0:.3f} s wall')
        with open(os.path.join(out_dir, 'per_graph.csv')) as f:
            graphs = list(csv.DictReader(f))
        with open(os.path.join(out_dir, 'per_atom.csv')) as f:
            atoms = list(csv.DictReader(f))
        for i, row in enumerate(graphs):
            forces = np.array([[float(a['fx']), float(a['fy']),
                                float(a['fz'])]
                               for a in atoms if int(a['graph']) == i])
            stress = np.array(json.loads(row['stress_kbar'])) / 1602.1766208
            check_served(f'inference graph {i}',
                         dict(energy=float(row['energy']), forces=forces,
                              stress=stress),
                         serve_gold['energy'][i], serve_gold[f'forces_{i}'],
                         serve_gold['stress'][i])
        params, _ = load_deployed(art)
    cap.check('md deployed requests')

    # --- D3 terms and GNN + D3 totals (pbe, bj) ---
    calc_d3 = Calculator(calc.spec, params, device='cuda', d3=MD_D3)
    for i, s in enumerate(structs):
        before = dict(_cuda.LAUNCHES)
        e3, f3, s3 = calc_d3.d3_terms(s)
        d3_launch = _launch_diff(before)
        e_rel = abs(e3 - gold['d3_energy'][i]) / abs(gold['d3_energy'][i])
        f_rel = _max_rel(f3, gold[f'd3_forces_{i}'])
        s_rel = _max_rel(s3, gold['d3_stress'][i])
        log(f'  d3 terms {i} ({len(s)} atoms): energy {e3:.6f} eV, rel '
            f'{e_rel:.2e}, forces rel {f_rel:.2e}, stress rel {s_rel:.2e}, '
            f'launches {d3_launch}')
        if not (e_rel <= D3_ENERGY_TOL and f_rel <= D3_TERM_TOL
                and s_rel <= D3_TERM_TOL):
            raise AssertionError(f'd3 terms {i} disagree with the golden '
                                 'file')
        before = dict(_cuda.LAUNCHES)
        res = calc_d3.calculate(s)
        md_census(f'd3 request {i}', _launch_diff(before), 1, True)
        check_served(f'GNN + D3 request {i}', res,
                     gold['total_energy'][i], gold[f'total_forces_{i}'],
                     gold['total_stress'][i])
    cap.check('md D3 requests')

    def new_md(structure, c):
        vv = VelocityVerlet(structure, calculator=c, dt_fs=MD['dt'],
                            skin=MD['skin'])
        vv.set_temperature(MD['T'], seed=MD['seed'])
        return vv

    # --- 96 atoms: the device loop against the golden ---
    vv = new_md(s0, calc)
    before = dict(_cuda.LAUNCHES)
    vv.run_device(MD['n_steps'], seg_steps=MD['seg_steps'])
    md_census('96-atom run_device', _launch_diff(before),
              MD['n_steps'] + 1, False)
    check_md_golden('96-atom run_device', vv, gold, 'md')
    cap.check('md 96-atom step')
    timed_md('96 run_device', lambda: vv.run_device(
        MD_TIMED_STEPS['96'], seg_steps=MD['seg_steps']),
        MD_TIMED_STEPS['96'], times)
    times['96 run_device']['segments'] = vv.result.segments
    wall, busy = profile_device('md 96-atom segment', lambda: vv.run_device(
        MD['seg_steps'], seg_steps=MD['seg_steps']))
    times['96 run_device']['profiled_busy_share'] = (
        None if busy is None else round(busy / wall, 4))
    cap.check('md 96-atom timed runs')

    # --- 96 atoms with D3 against the golden ---
    vv3 = new_md(s0, calc_d3)
    before = dict(_cuda.LAUNCHES)
    vv3.run_device(MD['n_steps_d3'], seg_steps=MD['seg_steps'])
    md_census('96-atom run_device with D3', _launch_diff(before),
              MD['n_steps_d3'] + 1, True)
    check_md_golden('96-atom run_device with D3', vv3, gold, 'md_d3')
    cap.check('md 96-atom D3 step')
    timed_md('96 d3 run_device', lambda: vv3.run_device(
        MD_TIMED_STEPS['96 d3'], seg_steps=MD['seg_steps']),
        MD_TIMED_STEPS['96 d3'], times)
    wall, busy = profile_device('md 96-atom segment with D3',
                                lambda: vv3.run_device(
                                    MD['seg_steps'],
                                    seg_steps=MD['seg_steps']))
    times['96 d3 run_device']['profiled_busy_share'] = (
        None if busy is None else round(busy / wall, 4))
    cap.check('md 96-atom D3 timed runs')

    # --- the host loop against the device loop from the same start (its
    # first steps' shapes checked untimed) ---
    calc.calculate(s0)
    calc_d3.calculate(s0)
    cap.check('md 96-atom host loop, first step')
    host, dev = new_md(s0, calc), new_md(s0, calc)
    timed_md('96 run', lambda: host.run(MD_RUN_STEPS), MD_RUN_STEPS, times)
    dev.run_device(MD_RUN_STEPS, seg_steps=MD['seg_steps'])
    e_rel = float(np.max(np.abs(np.array(host.result.energies)
                                - dev.result.energies)
                         / np.abs(dev.result.energies)))
    pos_err = float(np.abs(host.s.pos - dev.s.pos).max())
    log(f'  run against run_device, {MD_RUN_STEPS} steps: E_pot rel '
        f'{e_rel:.2e}, positions max-abs {pos_err:.2e} A')
    if not (e_rel <= MD_EPOT_TOL and pos_err <= MD_POS_TOL):
        raise AssertionError('the host loop disagrees with the device loop')
    host3 = new_md(s0, calc_d3)
    timed_md('96 d3 run', lambda: host3.run(MD_TIMED_RUN_STEPS['96 d3']),
             MD_TIMED_RUN_STEPS['96 d3'], times)
    e_rel = float(np.max(np.abs(
        np.array(host3.result.energies)
        - gold['md_d3_epot'][:MD_TIMED_RUN_STEPS['96 d3']])
        / np.abs(gold['md_d3_epot'][:MD_TIMED_RUN_STEPS['96 d3']])))
    log(f'  run with D3 against the golden device loop: E_pot rel '
        f'{e_rel:.2e}')
    if e_rel > MD_EPOT_TOL:
        raise AssertionError('the host loop with D3 disagrees with the '
                             'golden file')
    cap.check('md 96-atom host loops')

    # --- 768 atoms: extensivity, replicas, drift ---
    big = replicate(s0, 2, 2, 2)
    r96, r768 = calc.calculate(s0), calc.calculate(big)
    ext_rel = abs(r768['energy'] - 8 * r96['energy']) / abs(
        8 * r96['energy'])
    rep_err = float(np.abs(r768['forces'].reshape(8, len(s0), 3)
                           - r96['forces'][None]).max()
                    / np.abs(r96['forces']).max())
    log(f'  768-atom replicate: E_pot {r768["energy"]:.6f} against 8 x '
        f'{r96["energy"]:.6f}, rel {ext_rel:.2e} (limit '
        f'{MD_EXTENSIVE_TOL:g}); replicas\' forces rel {rep_err:.2e} '
        f'(limit {MD_REPLICA_FORCE_TOL:g})')
    if ext_rel > MD_EXTENSIVE_TOL or rep_err > MD_REPLICA_FORCE_TOL:
        raise AssertionError('the 768-atom replicate is not 8 copies of '
                             'the cell')
    vv8 = new_md(big, calc)
    before = dict(_cuda.LAUNCHES)
    vv8.run_device(MD768_STEPS, seg_steps=MD['seg_steps'])
    md_census('768-atom run_device', _launch_diff(before),
              MD768_STEPS + 1, False)
    cap.check('md 768-atom step')
    tot = np.array(vv8.result.total)
    drift = abs(tot[-1] - tot[0]) / len(big)
    log(f'  768-atom run_device: steps per segment {vv8.result.segments}, '
        f'E_tot {tot[0]:.6f} -> {tot[-1]:.6f}, drift {drift:.2e} eV/atom '
        f'(limit {MD_DRIFT_TOL:g})')
    if not (np.isfinite(tot).all() and drift < MD_DRIFT_TOL):
        raise AssertionError('768-atom NVE drift over its limit')
    timed_md('768 run_device', lambda: vv8.run_device(
        MD_TIMED_STEPS['768'], seg_steps=MD['seg_steps']),
        MD_TIMED_STEPS['768'], times)
    times['768 run_device']['segments'] = vv8.result.segments
    wall, busy = profile_device('md 768-atom segment', lambda: vv8.run_device(
        MD['seg_steps'], seg_steps=MD['seg_steps']))
    times['768 run_device']['profiled_busy_share'] = (
        None if busy is None else round(busy / wall, 4))
    host8 = new_md(big, calc)
    timed_md('768 run', lambda: host8.run(MD_TIMED_RUN_STEPS['768']),
             MD_TIMED_RUN_STEPS['768'], times)
    cap.check('md 768-atom timed runs')
    md_768_d3(
        big, lambda st, c=calc_d3: new_md(st, c), calc_d3, cap, times)

    # --- the FCTP self-connection (EXAMPLE_MD_MODEL, init_params(spec, 0))
    cfg = {K.NUM_SPECIES: 2, K.TYPE_MAP: {72: 0, 8: 1}, **EXAMPLE_MD_MODEL}
    spec = build_model_spec(cfg)
    fparams = init_params(spec, 0)
    fctp = Calculator(spec, fparams, device='cuda')
    fctp_cpu = Calculator(spec, fparams, device='cpu')
    for i, s in enumerate(structs):
        before = dict(_cuda.LAUNCHES)
        res = fctp.calculate(s)
        md_census(f'FCTP request {i}', _launch_diff(before), 1, False,
                  per_eval=FCTP_CENSUS)
        check_served(f'FCTP request {i} against the CPU plain path',
                     res, **{k: v for k, v in fctp_cpu.calculate(
                         s).items() if k in ('energy', 'forces', 'stress')})
    cap.check('md FCTP (4 channels)')
    vvf = new_md(s0, fctp)
    before = dict(_cuda.LAUNCHES)
    vvf.run_device(FCTP_STEPS, seg_steps=FCTP_STEPS)
    got = _launch_diff(before)
    md_census('FCTP run_device', got, FCTP_STEPS + 1, False,
              per_eval=FCTP_CENSUS)
    log(f'  FCTP run_device: {FCTP_STEPS} steps, segments '
        f'{vvf.result.segments}, E_tot {vvf.result.total[0]:.6f} -> '
        f'{vvf.result.total[-1]:.6f}, launches {got}')
    if not np.isfinite(vvf.result.total).all():
        raise AssertionError('FCTP run_device: non-finite energies')
    cap.check('md FCTP run_device')

    counts = dict(_cuda.LAUNCHES)
    log(f'[md] launches of the phase {counts}; {len(cap.checked)} distinct '
        f'kernel shapes, each against its plain version, largest '
        f'max_abs_err by check {cap.worst}; '
        f'{time.perf_counter() - t_phase:.1f} s')
    log('[md] ' + json.dumps({'md': times}))
    return counts


def family_configs(gold):
    """{name: flat model config} of the families golden (its one copy of
    the three configurations)."""
    from sevennet_finetuning_tpu_torch import keys as K

    cfgs = json.loads(str(gold['configs']))
    for cfg in cfgs.values():
        cfg[K.TYPE_MAP] = {int(z): i for z, i in cfg[K.TYPE_MAP]}
    return cfgs


def family_census(label, got, want):
    """The launches of one request or train step: exactly ``want`` of the
    families' kernels, none of the others."""
    from sevennet_finetuning_tpu_torch.ops import _cuda

    full = {k: want.get(k, 0) for k in _cuda.KERNELS}
    got = {k: got.get(k, 0) for k in _cuda.KERNELS}
    if got != full:
        raise AssertionError(f'{label}: launches {got}, expected {full}')


def family_kernel_rows(rows, calc_mace, calc_gaunt, structure):
    """The families' new kernel shapes on the 96-atom structure's graphs,
    each held against its plain version, timed and bounded (appended to
    ``rows``): cg_agg / cg_multi / cg_gagg / cg_gmulti at MACE's two
    layouts (l <= 3 filter, 128 channels up to l = 3), and segment_sum at
    the Gaunt aggregation's D = 1,152 and its source gather's backward,
    D = 10,368."""
    import torch

    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.ops import scatter
    from sevennet_finetuning_tpu_torch.ops.fused_conv import layout_from_spec

    gen = torch.Generator(device='cpu').manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to('cuda')

    b = calc_mace.batch(structure)
    dst = b[K.EDGE_IDX][0].contiguous()
    N = b[K.POS].shape[0]
    for t, blk in enumerate(calc_mace.spec.blocks):
        layout = layout_from_spec(blk.conv_tp)
        for name, cases in zip(('cg_agg', 'cg_multi', 'cg_gagg',
                                'cg_gmulti'),
                               conv_kernel_cases(f'mace block {t}', layout,
                                                 dst, N, randn,
                                                 x_grad=t > 0)):
            rows[name].extend(cases)
    b = calc_gaunt.batch(structure)
    dst = b[K.EDGE_IDX][0].contiguous()
    N = b[K.POS].shape[0]
    e = dst.shape[0]
    n_live = int((dst < N).sum())
    for D, label in ((1152, 'Gaunt aggregation'),
                     (10368, "Gaunt source gather's backward")):
        msg = randn(e, D)
        got = scatter.segment_sum_cuda(msg, dst, N)
        err = compare(f'segment_sum E={e} D={D} N={N}', got.cpu(),
                      scatter.segment_sum_plain(msg.cpu(), dst.cpu(), N),
                      0.0)
        same_bits(f'segment_sum E={e} D={D} N={N}',
                  lambda: scatter.segment_sum_cuda(msg, dst, N))
        idx_long = dst.long()

        def library():
            return torch.zeros(N + 1, D, device='cuda').index_add_(
                0, idx_long, msg)

        b_ms, b_by = bound_ms(4 * (n_live * D + e + N * D), n_live * D)
        rows['segment_sum'].append(dict(
            shape=f'E={e} D={D} N={N} ({label}, 96 atoms, '
                  f'{"staged" if scatter.segment_plan(e, D, N) else "rows"})',
            max_abs_err=err, bit_identical=True,
            ms=cuda_ms(lambda: scatter.segment_sum_cuda(msg, dst, N)),
            plain_ms=cuda_ms(lambda: scatter.segment_sum_plain(msg, dst, N)),
            library_ms=cuda_ms(library), bound_ms=b_ms, bound_by=b_by,
            device_us=device_us_per_call(
                lambda: scatter.segment_sum_cuda(msg, dst, N))))
    for name, cases in rows.items():
        for c in cases:
            if c['shape'].startswith('mace') or 'Gaunt' in c['shape']:
                log(f'  {name} [{c["shape"]}]: kernel {c["ms"]:.4f} ms, '
                    f'plain {c["plain_ms"]:.4f} ms, bound '
                    f'{c["bound_ms"] * 1e3:.1f} us ({c["bound_by"]})')


def phase_families(rows):
    """The MACE and Gaunt families at full width (``golden/
    families_jax_cpu.npz``'s configurations, init_params(spec, 0)) on the
    card: each serves ft.extxyz through ``Calculator`` against the golden
    (the serving limits) with its launch census per request; MACE and
    Gaunt take three train steps on ft900 structure 0 against the golden
    (the first step's loss within STEP0_TOL, every leaf's first-step
    gradient within GRAD_TOL of its max|g|, steps 2-3 within
    TRAJ_TOL) with their census per step; every distinct kernel shape
    launched is held against its plain version (``KernelCapture``).  Then
    the families' new kernel shapes are timed into ``rows``.  Returns the
    launch counts of the requests and train steps."""
    t_phase = time.perf_counter()
    with KernelCapture(FAMILY_KERNELS) as cap:
        counts, calcs, structure = _family_runs(cap)
    # the new shapes' timings (their launches are not the path's)
    family_kernel_rows(rows, calcs['mace_mp0_medium_widths'],
                       calcs['gaunt_sevennet0_widths'], structure)
    log(f'[families] phase {time.perf_counter() - t_phase:.1f} s')
    return counts


def _family_runs(cap):
    """The families' requests and train steps; returns the launch counts,
    the calculators by name and ft900 structure 0."""
    import numpy as np
    import torch

    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.data.dataset import (
        GraphDataset, Loader)
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.model.build import build_model_spec
    from sevennet_finetuning_tpu_torch.model.nequip import (
        NequIP, init_params, load_jax_params)
    from sevennet_finetuning_tpu_torch.ops import _cuda
    from sevennet_finetuning_tpu_torch.train.metrics import (
        init_accumulators)
    from sevennet_finetuning_tpu_torch.train.trainer import Trainer

    gold = np.load(GOLDEN_FAMILIES)
    cfgs = family_configs(gold)
    train = json.loads(str(gold['train_config']))
    structs = read_extxyz(str(FT))
    s900 = read_extxyz(str(FT900))[0]
    results, calcs = {}, {}
    _cuda.LAUNCHES.clear()
    for name, cfg in cfgs.items():
        spec = build_model_spec(cfg)
        params = init_params(spec, 0)
        calc = calcs[name] = Calculator(spec, params, device='cuda')
        n_par = sum(int(p.numel()) for p in calc.model.parameters())
        if n_par != int(gold[f'{name}/n_params']):
            raise AssertionError(f'{name}: {n_par} parameters, golden '
                                 f'{int(gold[f"{name}/n_params"])}')
        calc.calculate(structs[0])                   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for i, s in enumerate(structs):
            before = dict(_cuda.LAUNCHES)
            t0 = time.perf_counter()
            res = calc.calculate(s)
            ms.append((time.perf_counter() - t0) * 1e3)
            family_census(f'{name} request {i}', _launch_diff(before),
                          FAMILY_SERVE_CENSUS[name])
            check_served(f'{name} request {i} ({len(s)} atoms, '
                         f'{ms[-1]:.2f} ms)', res,
                         gold[f'{name}/energy'][i],
                         gold[f'{name}/forces_{i}'],
                         gold[f'{name}/stress'][i],
                         e_tol=FAMILY_ENERGY_TOL.get(name,
                                                     GOLDEN_ENERGY_TOL))
        peak = torch.cuda.max_memory_allocated() / 2**30
        cap.check(f'families {name} requests')
        wall, busy = profile_device(f'{name} 96-atom request',
                                    lambda: calc.calculate(structs[0]))
        results[name] = dict(
            params=n_par, request_ms=[round(x, 3) for x in ms],
            request_96_ms=round(float(np.median(ms[:4])), 3),
            request_96_device_ms=None if busy is None else round(busy, 3),
            request_96_profiled_wall_ms=round(wall, 3),
            serve_peak_gib=round(peak, 3),
            census_per_request=FAMILY_SERVE_CENSUS[name])
        log(f'[families] {name}: {n_par} parameters, 96-atom request '
            f'{results[name]["request_96_ms"]} ms wall (median of 4), '
            f'device {results[name]["request_96_device_ms"]} ms, peak '
            f'memory {peak:.3f} GiB')
        cap.check(f'families {name} profiled request')

    for name in train['trained']:
        cfg = cfgs[name]
        spec = calcs[name].spec
        trainer = Trainer(load_jax_params(NequIP(spec), init_params(spec, 0)),
                          {**cfg, **train['recipe']}, device='cuda')
        ds = GraphDataset.from_structures([s900], spec.cutoff,
                                          cfg[K.TYPE_MAP])
        batch = trainer.place_batch(next(iter(Loader(ds, 1))))
        acc = init_accumulators(trainer.metric_specs, trainer.device)
        tgold = {k: gold[f'{name}/train/{k}'] for k in FAMILY_TERMS}
        weights = {ls.name: ls.weight for ls in trainer.loss_specs}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for step in range(train['steps']):
            before = dict(_cuda.LAUNCHES)
            t0 = time.perf_counter()
            acc, terms = trainer.train_step(batch, acc)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            family_census(f'{name} train step {step}', _launch_diff(before),
                          FAMILY_TRAIN_CENSUS[name])
            check_terms(name, dict(terms), tgold, step, weights,
                        STEP0_TOL if step == 0 else TRAJ_TOL,
                        names=FAMILY_TERMS)
            if step == 0:
                check_grads(name, trainer, gold, prefix=f'{name}/grad/')
        peak = torch.cuda.max_memory_allocated() / 2**30
        cap.check(f'families {name} train steps')
        wall, busy = profile_device(
            f'{name} train step', lambda: trainer.train_step(batch, acc))
        cap.check(f'families {name} profiled train step')
        results[name].update(
            train_step_ms=[round(x, 3) for x in ms],
            train_step_device_ms=None if busy is None else round(busy, 3),
            train_peak_gib=round(peak, 3),
            census_per_train_step=FAMILY_TRAIN_CENSUS[name])
        r = results[name]
        log(f'[families] {name} train: ms per step {r["train_step_ms"]}, '
            f'device {r["train_step_device_ms"]} ms, peak memory '
            f'{peak:.3f} GiB')

    counts = dict(_cuda.LAUNCHES)
    log(f'[families] launches of the phase {counts}; {len(cap.checked)} '
        f'distinct kernel shapes, each against its plain version, largest '
        f'max_abs_err by check {cap.worst}')
    log('[families] ' + json.dumps({'families': results}))
    return counts, calcs, s900


def pair_e3gnn_inputs(s, g, type_map, device):
    """The input dict LAMMPS pair_e3gnn builds for one cell
    (pair_e3gnn.cpp:205-215), on ``device``."""
    import numpy as np
    import torch

    from sevennet_finetuning_tpu_torch import keys as K

    return {
        'x': torch.tensor([type_map[int(z)] for z in s.atomic_numbers],
                          dtype=torch.long, device=device),
        'pos': torch.tensor(np.asarray(s.pos), dtype=torch.float32,
                            device=device, requires_grad=True),
        'edge_index': torch.tensor(np.asarray(g[K.EDGE_IDX]),
                                   dtype=torch.long, device=device),
        'pbc_shift': torch.tensor(np.asarray(g[K.CELL_SHIFT]),
                                  dtype=torch.float32, device=device),
        'cell_lattice_vectors': torch.tensor(
            np.asarray(s.cell), dtype=torch.float32, device=device),
        'cell_volume': torch.tensor(float(s.volume), device=device),
        'num_atoms': torch.tensor(len(s), device=device),
    }


def chain_segments(segs, types, idx, edge_vec, device):
    """The parallel segment chain in one domain without ghosts, as
    pair_e3gnn_parallel.cpp:207-541 runs it: each segment's forward, then
    the manual backward that chains the cotangents of x and
    self_cont_tmp and sums dE/d(edge_vec) over the segments.  Returns
    (energy, forces) with forces from the accumulated dE/dr."""
    import numpy as np
    import torch

    n = len(types)
    ev = torch.tensor(edge_vec, dtype=torch.float32, device=device,
                      requires_grad=True)
    out = segs[0]({
        'x': torch.tensor(types, dtype=torch.long, device=device),
        'x_ghost': torch.zeros((0,), dtype=torch.long, device=device),
        'edge_index': torch.tensor(idx, dtype=torch.long, device=device),
        'edge_vec': ev, 'num_atoms': torch.tensor([n], device=device),
        'nlocal': torch.tensor([n], device=device)})
    wrt = [[ev]]
    for seg in segs[1:]:
        e_v = out['edge_vec'].clone()
        xg = torch.zeros((0, out['x'].shape[1]), device=device,
                         requires_grad=True)
        out = dict(out, edge_vec=e_v, x_ghost=xg)
        wrt.append([e_v, out['x'], out['self_cont_tmp'], xg])
        out = seg(out)
    energy = out['inferred_total_energy'].squeeze()
    dE_dr = torch.zeros_like(ev)
    gx = gtmp = of = None
    for i in range(len(wrt) - 1, -1, -1):
        if i == len(wrt) - 1:
            grads = torch.autograd.grad([energy], wrt[i], allow_unused=True)
        else:
            grads = torch.autograd.grad(of, wrt[i], [gx, gtmp],
                                        allow_unused=True)
        if grads[0] is not None:
            dE_dr = dE_dr + grads[0]
        if i == 0:
            break
        of = [wrt[i][1], wrt[i][2]]
        gx, gtmp = grads[1], grads[2]
    d = dE_dr.detach().cpu().numpy().astype(np.float64)
    f = np.zeros((n, 3))
    np.add.at(f, idx[0], d)        # dst
    np.add.at(f, idx[1], -d)       # src
    return float(energy.detach()), f


def compat_reference_pth(tmp, blob, spec):
    """Check 1: the checkpoint as a reference training .pth (the layout of
    the reference's trainer.py:98-107, its type map by symbol) through
    ``Calculator.from_checkpoint`` on the card: every parameter bit-equal
    to the checkpoint's, the five requests at the serving limits with the
    serve census.  Returns (results, launch counts)."""
    import numpy as np
    import torch

    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.compat.state_dict_import import (
        state_dict_from_params)
    from sevennet_finetuning_tpu_torch.data.elements import z_to_symbol

    sd = state_dict_from_params(spec, blob['model_state_dict'])
    cfg = dict(blob['config'])
    cfg[K.TYPE_MAP] = {z_to_symbol(z): i for z, i in cfg[K.TYPE_MAP].items()}
    path = tmp / 'checkpoint_reference.pth'
    torch.save({'model_state_dict': {k: torch.from_numpy(
        np.ascontiguousarray(v)) for k, v in sd.items()}, 'config': cfg,
        'epoch': blob['epoch']}, str(path))
    t0 = time.perf_counter()
    calc = Calculator.from_checkpoint(str(path), device='cuda')
    load_s = time.perf_counter() - t0
    n_leaves = 0
    for g, names in blob['model_state_dict'].items():
        for n, want in names.items():
            got = calc.model.params[g][n].detach().cpu().numpy()
            if not (got.dtype == np.float32 and np.array_equal(
                    got, np.asarray(want, np.float32))):
                raise AssertionError(f'reference .pth: {g}/{n} differs from '
                                     'the checkpoint')
            n_leaves += 1
    log(f'  reference .pth ({len(sd)} state-dict tensors, '
        f'{path.stat().st_size} bytes, epoch {blob["epoch"]}): '
        f'Calculator.from_checkpoint {load_s:.2f} s, {n_leaves} leaves '
        'bit-equal to the checkpoint')
    results = []
    counts = phase_serve(calc, results, label='compat reference .pth')
    return results, counts


def compat_torchscript_serial(tmp, spec, served):
    """Check 2: ``main get_model <ckpt> --torchscript``; the artifact on
    the card through pair_e3gnn's input dict against the golden and the
    port's Calculator (serving limits), atomic energies summing to the
    total, its metadata, and what compat/torchscript_import reads from the
    graph the card's torch froze."""
    import numpy as np
    import torch

    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.compat import torchscript_import
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.main import main as cli
    from sevennet_finetuning_tpu_torch.model.graph import structure_to_graph
    from sevennet_finetuning_tpu_torch.ops import _cuda

    gold = np.load(GOLDEN)
    t0 = time.perf_counter()
    cli(['get_model', str(CKPT), '--torchscript', '-o',
         str(tmp / 'deployed_serial.sevenn')])
    export_s = time.perf_counter() - t0
    path = tmp / 'deployed_serial.pt'
    meta = dict.fromkeys(('chemical_symbols_to_index', 'cutoff',
                          'num_species', 'model_type', 'version', 'dtype',
                          'time'), '')
    model = torch.jit.load(str(path), map_location='cuda', _extra_files=meta)
    meta = {k: v.decode() if isinstance(v, bytes) else v
            for k, v in meta.items()}
    shown = dict(meta, chemical_symbols_to_index='...')
    log(f'  get_model --torchscript: {path.stat().st_size} bytes in '
        f'{export_s:.2f} s; metadata {shown}')
    if (len(meta['chemical_symbols_to_index'].split()) != 89
            or float(meta['cutoff']) != 5.0 or meta['num_species'] != '89'
            or meta['model_type'] != 'E3_equivariant_model'
            or meta['dtype'] != 'single'):
        raise AssertionError(f'TorchScript metadata {meta}')
    tm = dict(spec.type_map)
    for i, s in enumerate(read_extxyz(str(FT))):
        g = structure_to_graph(s, spec.cutoff, tm)
        before = dict(_cuda.LAUNCHES)
        t0 = time.perf_counter()
        out = model(pair_e3gnn_inputs(s, g, tm, 'cuda'))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if _launch_diff(before):
            raise AssertionError('the TorchScript artifact launched a '
                                 f'kernel of csrc: {_launch_diff(before)}')
        res = {'energy': float(out['inferred_total_energy'].detach()),
               'forces': out['inferred_force'].detach().cpu().numpy(),
               'stress': out['inferred_stress'].detach().cpu().numpy()}
        ae = float(out['atomic_energy'].detach().sum())
        log(f'  torchscript request {i} ({len(s)} atoms): {ms:.2f} ms, '
            f'sum of atomic energies - total {ae - res["energy"]:.3e} eV')
        check_served(f'torchscript request {i} vs golden', res,
                     gold['energy'][i], gold[f'forces_{i}'],
                     gold['stress'][i])
        check_served(f'torchscript request {i} vs Calculator', res,
                     served[i]['energy'], served[i]['forces'],
                     served[i]['stress'])
        if abs(ae - res['energy']) > GOLDEN_ENERGY_TOL * abs(res['energy']):
            raise AssertionError(f'atomic energies sum to {ae}, total '
                                 f'{res["energy"]}')
    # steady state at one shape: each request above was the artifact's
    # first at its edge count (the TorchScript executor profiles and
    # specialises a new shape before it optimises it)
    s = read_extxyz(str(FT))[0]
    g = structure_to_graph(s, spec.cutoff, tm)
    times = []
    for _ in range(12):
        inp = pair_e3gnn_inputs(s, g, tm, 'cuda')
        t0 = time.perf_counter()
        model(inp)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f'  torchscript: structure 0 twelve times, ms '
        f'{[round(t, 2) for t in times]}; median of the last eight '
        f'{np.median(times[4:]):.3f} ms')
    # the graph as the card's torch froze it, read on the host
    host = torch.jit.load(str(path), map_location='cpu')
    code, consts = host.code_with_constants
    cfg = torchscript_import._config_from_frozen(code, consts.const_mapping,
                                                 meta)
    frozen_tm = cfg.pop(K.TYPE_MAP)
    shapes = tuple(tuple(a.shape) for a, _, _ in
                   torchscript_import._extract_weight_ops(host.graph))
    log(f'  _config_from_frozen on the card\'s frozen graph: {cfg} (type '
        f'map of {len(frozen_tm)} species); _extract_weight_ops: '
        f'{len(shapes)} weighted ops (CPU: {len(TS_WEIGHT_OP_SHAPES)})')
    if frozen_tm != tm or cfg != TS_FROZEN_CONFIG:
        raise AssertionError(f'_config_from_frozen reads {cfg}, the CPU '
                             f'{TS_FROZEN_CONFIG}')
    if shapes != TS_WEIGHT_OP_SHAPES:
        raise AssertionError(f'_extract_weight_ops finds {shapes}, the CPU '
                             f'{TS_WEIGHT_OP_SHAPES}')


def compat_torchscript_parallel(tmp, spec):
    """Check 3: ``get_model --torchscript -p``: five segment files with
    comm_size of the spec, chained in one domain on the card over
    structure 0 of ft.extxyz, energy and forces (from dE/dr) against the
    serving golden within PAR_ENERGY_TOL / PAR_FORCE_TOL."""
    import numpy as np
    import torch

    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.compat.torchscript_export_parallel \
        import comm_size_of
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.main import main as cli
    from sevennet_finetuning_tpu_torch.model.graph import structure_to_graph
    from sevennet_finetuning_tpu_torch.ops import _cuda

    gold = np.load(GOLDEN)
    t0 = time.perf_counter()
    cli(['get_model', str(CKPT), '--torchscript', '-p', '-o',
         str(tmp / 'deployed_parallel.sevenn')])
    export_s = time.perf_counter() - t0
    ts_dir = tmp / 'deployed_parallel_parallel'
    names = sorted(p.name for p in ts_dir.iterdir())
    if names != [f'deployed_parallel_{i}.pt' for i in range(5)]:
        raise AssertionError(f'segment files {names}')
    meta = {'comm_size': ''}
    segs = [torch.jit.load(str(ts_dir / n), map_location='cuda',
                           _extra_files=meta if i == 0 else {})
            for i, n in enumerate(names)]
    comm = int(meta['comm_size'])
    if comm != comm_size_of(spec):
        raise AssertionError(f'comm_size {comm} != {comm_size_of(spec)}')
    s = read_extxyz(str(FT))[0]
    tm = dict(spec.type_map)
    g = structure_to_graph(s, spec.cutoff, tm)
    idx = np.asarray(g[K.EDGE_IDX])
    ev = (np.asarray(s.pos)[idx[1]] - np.asarray(s.pos)[idx[0]]
          + np.asarray(g[K.CELL_SHIFT]) @ np.asarray(s.cell))
    types = np.array([tm[int(z)] for z in s.atomic_numbers])
    before = dict(_cuda.LAUNCHES)
    times = []
    for _ in range(8):             # the executor's warm-up at this shape
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e, f = chain_segments(segs, types, idx, ev, 'cuda')
        times.append((time.perf_counter() - t0) * 1e3)
    if _launch_diff(before):
        raise AssertionError('the segments launched a kernel of csrc')
    ms = (f'{[round(t, 2) for t in times]}, median of the last four '
          f'{np.median(times[4:]):.3f}')
    e_err = abs(e - float(gold['energy'][0])) / len(s)
    f_err = float(np.abs(f - gold['forces_0']).max())
    log(f'  get_model --torchscript -p: {len(segs)} segments, comm_size '
        f'{comm}, exported in {export_s:.2f} s; chain (forward and manual '
        f'backward) over {len(s)} atoms eight times, ms {ms}: energy err '
        f'{e_err:.3e} eV/atom (limit {PAR_ENERGY_TOL:g}), forces max err '
        f'{f_err:.3e} eV/A (limit {PAR_FORCE_TOL:g})')
    if e_err > PAR_ENERGY_TOL or f_err > PAR_FORCE_TOL:
        raise AssertionError('the parallel chain disagrees with the golden '
                             'file')


def _csv_rows(path):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


FT_STAGE_CENSUS = {k: 6 * TRAIN_CENSUS[k] + 3 * v for k, v in
                   {'cg_agg': 5, 'cg_multi': 5, 'cg_gagg': 0, 'cg_gmulti': 0,
                    'cg_quad': 0}.items()}


def compat_sevenn_data(tmp, pipeline_dir, spec):
    """Check 4: ``main graph_build`` of the pipeline phase's fine-tune data
    and an artifact built with the checkpoint's type map, each the
    ``load_dataset_path`` of that phase's reEWC stage (its own Fisher
    artifacts): log.csv within COMPAT_CSV_TOL of the extxyz run's, the
    stage's census, and whether the stage reused the prebuilt graphs or
    rebuilt them from the stored structures.  Returns the launch
    counts."""
    from collections import Counter

    import torch
    import yaml

    from sevennet_finetuning_tpu_torch.data import dataset
    from sevennet_finetuning_tpu_torch.main import main as cli
    from sevennet_finetuning_tpu_torch.ops import _cuda
    from sevennet_finetuning_tpu_torch.pipeline import _read_file
    from sevennet_finetuning_tpu_torch.train.recipe import pipeline_stages

    art = tmp / 'ft_graph_build.sevenn_data'
    cli(['graph_build', str(FT), str(spec.cutoff), '-o', str(art)])
    reuse = tmp / 'ft_checkpoint_type_map.sevenn_data'
    structs = _read_file(str(FT), 'structure_list')
    tm = dict(spec.type_map)
    dataset.save_sevenn_data(str(reuse), dataset.GraphDataset.from_structures(
        structs, spec.cutoff, tm), spec.cutoff, tm, structures=structs)
    want = _csv_rows(pipeline_dir / 'ft_out' / 'log.csv')
    label = structs[0].info['label']
    built = []
    orig = dataset.GraphDataset.from_structures

    def recording(structures, *args, **kwargs):
        built.append(sum(s.info.get('label') == label for s in structures))
        return orig(structures, *args, **kwargs)

    total = Counter()
    for name, path in (('graph_build', art), ('checkpoint type map', reuse)):
        blob = dataset._load_blob(str(path))
        stored = {int(z): int(i) for z, i in blob['type_map'].items()}
        cfg = pipeline_stages(ROOT, str(pipeline_dir / 'fisher_out'))[1]
        cfg['data']['load_dataset_path'] = [str(path)]
        wd = tmp / name.replace(' ', '_')
        y = tmp / f'{wd.name}.yaml'
        y.write_text(yaml.safe_dump(cfg))
        built.clear()
        before = dict(_cuda.LAUNCHES)
        dataset.GraphDataset.from_structures = staticmethod(recording)
        t0 = time.perf_counter()
        try:
            cli(['train', str(y), '-w', str(wd)])
            torch.cuda.synchronize()
        finally:
            dataset.GraphDataset.from_structures = staticmethod(orig)
        wall = time.perf_counter() - t0
        counts = _launch_diff(before)
        total.update(counts)
        rebuilt = sum(built)
        how = (f'rebuilt from its {rebuilt} stored structures' if rebuilt
               else 'trained on its prebuilt graphs')
        log(f'  {name} artifact ({len(blob["graphs"])} graphs, type map of '
            f'{len(stored)} species, cutoff {blob["cutoff"]}): the stage '
            f'{how}; {wall:.2f} s wall; launches {counts}')
        if bool(rebuilt) == (stored == tm) or rebuilt not in (0, 5):
            raise AssertionError(f'{name}: {rebuilt} structures rebuilt')
        if any(counts.get(k, 0) != v for k, v in FT_STAGE_CENSUS.items()) \
                or counts.get('segment_sum', 0) < 6 * TRAIN_CENSUS[
                    'segment_sum']:
            raise AssertionError(f'{name}: launches {counts}, expected '
                                 f'{FT_STAGE_CENSUS}')
        got = _csv_rows(wd / 'log.csv')
        if len(got) != len(want) or list(got[0]) != list(want[0]):
            raise AssertionError(f'{name}: log.csv rows or columns differ')
        worst = (0.0, '')
        for i, (a, b) in enumerate(zip(got, want)):
            for col in b:
                x, w = float(a[col]), float(b[col])
                rel = abs(x - w) / abs(w) if w else abs(x)
                if rel > worst[0]:
                    worst = (rel, f'row {i} {col}')
        log(f'  {name}: log.csv against the extxyz run: largest relative '
            f'difference {worst[0]:.3e} ({worst[1] or "all bit-equal"}; '
            f'limit {COMPAT_CSV_TOL:g})')
        if worst[0] > COMPAT_CSV_TOL:
            raise AssertionError(f'{name}: log.csv differs from the extxyz '
                                 'run')
    return dict(total)


def compat_continue(blob):
    """Check 5: the checkpoint continued with its own adam state (no
    reset_optimizer) for two batch-8 steps (ft900, then replay900) at LR
    1e-4, against ``golden/continue_ft900_jax_cpu.npz``: the first step's
    loss terms (STEP0_TOL, RAW_TERM_TOL) and gradients (GRAD_TOL, against
    ``train_ft900_jax_cpu.npz``'s first step, the same one), the second
    step's (TRAJ_TOL), each step's census; every leaf's first
    update beside the golden's.  The same steps from a reset optimizer
    must miss the second step's limit (the state moves the update).
    Returns the launch counts."""
    from collections import Counter

    import numpy as np
    import torch

    from sevennet_finetuning_tpu_torch import keys as K
    from sevennet_finetuning_tpu_torch.data.dataset import (
        GraphDataset, Loader)
    from sevennet_finetuning_tpu_torch.data.readers import read_extxyz
    from sevennet_finetuning_tpu_torch.train.metrics import init_accumulators
    from sevennet_finetuning_tpu_torch.train.optim import set_lr

    gold = np.load(GOLDEN_CONTINUE)
    total = Counter()
    second = {}
    for restored in (True, False):
        label = 'restored' if restored else 'reset'
        trainer = new_trainer()
        if restored:
            trainer.load_optimizer_state(blob['optimizer_state_dict'])
            state = trainer.optimizer.state_dict()
            log(f'  optax state: {len(state["state"])} adam leaves, step '
                f'{float(state["state"][0]["step"]):.0f}, its LR '
                f'{state["param_groups"][0]["lr"]:.6e} set to 1e-4')
            set_lr(trainer.optimizer, 1e-4)
        weights = {ls.name: ls.weight for ls in trainer.loss_specs}
        tm = dict(trainer.spec.type_map)
        loaders = [Loader(GraphDataset.from_structures(
            read_extxyz(str(p))[:24], trainer.spec.cutoff, tm), BATCH)
            for p in (FT900, REPLAY900)]
        if loaders[0].n_edge != int(gold['n_edge_slots']):
            raise AssertionError(f'edge slots {loaders[0].n_edge} != golden '
                                 f'{int(gold["n_edge_slots"])}')
        batches = [trainer.place_batch(next(iter(ld))) for ld in loaders]
        before = {g: {n: p.detach().clone() for n, p in names.items()}
                  for g, names in trainer.params.items()}
        acc = init_accumulators(trainer.metric_specs, trainer.device)
        acc, terms, counts, ms = step_census(trainer, batches[0], acc)
        total.update(counts)
        check_terms(f'continue {label}', terms, gold, 0, weights, STEP0_TOL,
                    RAW_TERM_TOL)
        if restored:
            # the first step is the train golden's (same parameters and
            # batch): its gradients are the continue golden's too
            check_grads('ft900', trainer, np.load(GOLDEN_FT900))
        shares = []
        for g, names in trainer.params.items():
            for n, p in names.items():
                got = (p.detach() - before[g][n]).cpu().numpy()
                want = gold[f'update/{g}/{n}']
                after = before[g][n].cpu().numpy() + want
                limit = 1e-3 * float(np.abs(want).max()) + 2 * float(
                    np.finfo(np.float32).eps) * float(np.abs(after).max())
                shares.append((float(np.abs(got - want).max()) / limit,
                               f'{g}/{n}'))
        shares.sort(reverse=True)
        log(f'  continue {label}: first update per leaf against the '
            "golden's (max err / (1e-3 max|update| + 2 ulp)): worst "
            + ', '.join(f'{k} {v:.2f}' for v, k in shares[:3]))
        acc, terms, counts, ms = step_census(trainer, batches[1], acc)
        total.update(counts)
        second[label] = float(terms['Total'])
        if restored:
            check_terms(f'continue {label}', terms, gold, 1, weights,
                        TRAJ_TOL)
    miss = abs(second['reset'] / float(gold['Total'][1]) - 1)
    log(f'  continue: second-step total restored {second["restored"]:.9e}, '
        f'reset {second["reset"]:.9e}, JAX {float(gold["Total"][1]):.9e}; '
        f'the reset run misses by {miss:.3f} (limit {TRAJ_TOL:g})')
    if miss <= TRAJ_TOL:
        raise AssertionError('a reset optimizer passes the continue check: '
                             'it cannot tell a restored state from none')
    return dict(total)


# launches of the compat phase: five requests (serve census), two
# fine-tune stages (FT_STAGE_CENSUS), four train steps (two restored, two
# reset); segment-sum at least that many
COMPAT_CENSUS = {k: 5 * {'cg_agg': 5, 'cg_multi': 5}.get(k, 0)
                 + 2 * FT_STAGE_CENSUS.get(k, 0) + 4 * TRAIN_CENSUS[k]
                 for k in ('cg_agg', 'cg_multi', 'cg_gagg', 'cg_gmulti',
                           'cg_quad')}
COMPAT_MIN_SEGMENT_SUMS = 5 * 8 + 2 * 6 * 13 + 4 * 13


def phase_compat(pipeline_dir):
    """Checkpoint and deploy interop at SevenNet-0's full width: a
    reference .pth served, the serial and parallel TorchScript artifacts
    of ``get_model --torchscript`` on the card, ``graph_build`` and
    .sevenn_data fine-tunes against the pipeline phase's, and a continue
    of the checkpoint's optax state against its golden.  Returns the
    phase's launch counts."""
    from collections import Counter

    import torch

    from sevennet_finetuning_tpu_torch.model.build import build_model_spec
    from sevennet_finetuning_tpu_torch.ops import _cuda
    from sevennet_finetuning_tpu_torch.tools.bench_dma import card_line
    from sevennet_finetuning_tpu_torch.train.checkpoint import (
        load_checkpoint)

    t_phase = time.perf_counter()
    log(f'[compat] {card_line()}')
    blob = load_checkpoint(str(CKPT))
    spec = build_model_spec(blob['config'])
    counts = Counter()
    times = {}
    torch.cuda.synchronize()
    _cuda.LAUNCHES.clear()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        served, serve_counts = compat_reference_pth(tmp, blob, spec)
        counts.update(serve_counts)
        times['reference .pth'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        compat_torchscript_serial(tmp, spec, served)
        times['torchscript'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        compat_torchscript_parallel(tmp, spec)
        times['torchscript -p'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        counts.update(compat_sevenn_data(tmp, pipeline_dir, spec))
        times['.sevenn_data'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts.update(compat_continue(blob))
    times['continue'] = time.perf_counter() - t0
    counts = {k: counts.get(k, 0) for k in _cuda.KERNELS}
    log(f'[compat] launches of the phase {counts}; expected '
        f'{COMPAT_CENSUS}, segment_sum >= {COMPAT_MIN_SEGMENT_SUMS}, no '
        'probe')
    if (any(counts[k] != v for k, v in COMPAT_CENSUS.items())
            or counts['segment_sum'] < COMPAT_MIN_SEGMENT_SUMS
            or any(counts[k] for k in PROBES)):
        raise AssertionError(f'compat launches {counts}')
    log(f'[compat] phase {time.perf_counter() - t_phase:.1f} s ('
        + ', '.join(f'{k} {v:.1f} s' for k, v in times.items()) + ')')
    return counts

def _rel_l2(got, want):
    import numpy as np

    num = sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
    den = sum(float(np.sum(want[k] ** 2)) for k in want)
    return (num / den) ** 0.5


# the runs of f64_reference: (label, device, dtype name)
F64_RUNS = (('card f32', 'cuda', 'float32'), ('cpu f64', 'cpu', 'float64'))


def _leaf_rel(got, want):
    """max|got - want| / max|want| of one leaf."""
    import numpy as np

    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def f64_reference(n_steps=6):
    """The first ``n_steps`` ft900 rehearsal steps of the train phase (same
    batches, same recipe), taken in float32 on the card and in float64 on
    the host CPU (the kernels' plain versions): how far the card's and the
    JAX-CPU golden's float32 loss terms, step by step, and first-step
    gradients, leaf by leaf, lie from the float64 ones."""
    import numpy as np
    import torch

    from sevennet_finetuning_tpu_torch.train.metrics import init_accumulators

    gold = np.load(GOLDEN_FT900)
    runs = {'JAX-CPU f32': (
        [{k: float(gold[k][i]) for k in TRAIN_TERMS}
         for i in range(n_steps)],
        {k: gold[k].astype(np.float64) for k in gold.files
         if k.startswith('grad/')})}
    for label, device, dtype_name in F64_RUNS:
        dtype = getattr(torch, dtype_name)
        torch.set_default_dtype(dtype)
        t0 = time.perf_counter()
        trainer = new_trainer(device, dtype)
        _, _, tb, mb = ft900_batches(trainer, gold)
        order = [b for pair in zip(tb, mb) for b in pair][:n_steps]
        acc = init_accumulators(trainer.metric_specs, trainer.device)
        rows, grads = [], None
        for b in order:
            b = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in b.items()}
            acc, terms = trainer.train_step(b, acc)
            rows.append({k: float(terms[k]) for k in TRAIN_TERMS})
            if grads is None:
                grads = {f'grad/{g}/{n}': p.grad.double().cpu().numpy()
                         for g, names in trainer.params.items()
                         for n, p in names.items()}
        runs[label] = (rows, grads)
        log(f'[f64] {label}: {n_steps} steps in '
            f'{time.perf_counter() - t0:.1f} s, totals '
            f'{[r["Total"] for r in rows]}')
    torch.set_default_dtype(torch.float32)
    ref_rows, ref_g = runs['cpu f64']
    card_rows, card_g = runs['card f32']
    jax_rows, jax_g = runs['JAX-CPU f32']
    for label, g in (('card f32', card_g), ('JAX-CPU f32', jax_g)):
        log(f'[f64] {label} vs cpu f64: first-step gradient relative L2 '
            f'{_rel_l2(g, ref_g):.3e}')
    log(f'[f64] card f32 vs JAX-CPU f32: first-step gradient relative L2 '
        f'{_rel_l2(card_g, jax_g):.3e}')

    # every step's raw loss terms: float64, card and JAX, and the card's
    # and JAX's relative distance from float64
    log('[f64] raw loss terms per step: cpu f64 | card f32 (rel to f64) | '
        'JAX-CPU f32 (rel to f64)')
    for i, ref in enumerate(ref_rows):
        for k in TRAIN_TERMS:
            c, j, r = card_rows[i][k], jax_rows[i][k], ref[k]
            log(f'  step {i} {k:6s}: {r:.9e} | {c:.9e} '
                f'({abs(c - r) / abs(r):.2e}) | {j:.9e} '
                f'({abs(j - r) / abs(r):.2e})')

    # every leaf of the first-step gradient: max-abs error over the
    # float64 leaf's max|g|, for the card and JAX, and card against JAX as
    # the train phase's check_grads measures it (over JAX's max|g|)
    log('[f64] first-step gradient per leaf (max-abs err / max|g|): '
        'max|g| f64 | card vs f64 | JAX vs f64 | card vs JAX')
    leaves = []
    for key in sorted(ref_g):
        leaves.append((_leaf_rel(card_g[key], jax_g[key]), key,
                       float(np.abs(ref_g[key]).max()),
                       _leaf_rel(card_g[key], ref_g[key]),
                       _leaf_rel(jax_g[key], ref_g[key])))
    for cj, key, scale, cf, jf in sorted(leaves, reverse=True):
        log(f'  {key[5:]:36s} {scale:.3e} | {cf:.2e} | {jf:.2e} | {cj:.2e}')


def main():
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    if not PKG.is_dir():
        print(f'chip_smoke: {PKG} is missing', file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from sevennet_finetuning_tpu_torch.calculator import Calculator
    from sevennet_finetuning_tpu_torch.tools.bench_dma import card_line

    card = card_line()
    log(f'[device] {torch.cuda.get_device_name(0)} | {card} | torch '
        f'{torch.__version__} cuda {torch.version.cuda}')
    phase_build()
    if sys.argv[1:] == ['--f64-reference']:
        with neighbor_builder('ckdtree'):
            f64_reference()
        return 0
    probe_rows, probe_counts = phase_probes()
    # the phases but md build their graphs with the cKDTree neighbor list,
    # as the port did before it had the native one (the train, pipeline
    # and continue goldens were made with it); md takes the native list.
    # The pipeline phase's directory lives on for the compat phase
    work = tempfile.TemporaryDirectory()
    try:
        with neighbor_builder('ckdtree'):
            calc = Calculator.from_checkpoint(str(CKPT), device='cuda')
            batch, n_real_edge = batch8(calc)
            rows = phase_kernels(calc, batch, n_real_edge)
            serve_counts = phase_serve(calc)
            phase_batch(calc, batch, n_real_edge)
            phase_profile(calc, batch)
            del calc
            path_counts = {'serve': serve_counts, 'train': phase_train(),
                           'pipeline': phase_pipeline(work.name),
                           'unsorted': phase_unsorted(batch),
                           'probes': probe_counts,
                           'families': phase_families(rows)}
        path_counts['md'] = phase_md()
        with neighbor_builder('ckdtree'):
            path_counts['compat'] = phase_compat(Path(work.name))
    finally:
        work.cleanup()

    # one row per kernel at its interior-block / widest shape; every
    # measured shape is under "cases".  "launches" is the count on the
    # path named by "path" (one train step, one unsorted pass, or one run
    # of the two probes' entry points); "launches_per_path" holds every
    # path's: the five serve requests' total, one train step's, one
    # unsorted pass's, the probes' run
    for path, names in PATH_KERNELS.items():
        for name in names:
            if path_counts[path].get(name, 0) == 0:
                raise AssertionError(f'{name} was never launched on the '
                                     f'{path} path')
    # the probes' rows: the case of PROBE_CASE (em te=256; the ring of 8
    # rows, 4 slots, split 2), else the first (te=256, the feature
    # probes' only case); 8a and 8c also give their worst factor against
    # torch.mul over the sweep
    kernels = []
    for name, cases in {**rows, **probe_rows}.items():
        c = (cases[2] if name == 'segment_sum' else
             next(c for c in cases
                  if c['shape'].startswith(PROBE_CASE.get(name, '')))
             if name in PROBES else
             next(c for c in cases if c['shape'].startswith('block 1')))
        kernels.append(dict(
            name=name, route='cuda', **SOURCES[name],
            path=KERNEL_PATH[name],
            launches=path_counts[KERNEL_PATH[name]][name],
            launches_per_path={path: counts.get(name, 0)
                               for path, counts in path_counts.items()},
            max_abs_err=c['max_abs_err'], ms=c['ms'],
            plain_ms=c['plain_ms'], bound_ms=c['bound_ms'],
            bound_by=c['bound_by'], library_ms=c['library_ms'],
            shape=c['shape'], cases=cases))
        if 'factor' in c:
            kernels[-1]['worst_factor'] = max(k['factor'] for k in cases)
    print(card, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
