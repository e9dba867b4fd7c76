"""Run logger: screen + log file + machine-readable CSV.

A copy of ``sevennet_finetuning_tpu/logger.py``, the counterpart of the
reference's singleton logger (reference: sevenn/sevenn_logger.py:25-339):
config dump, dataset statistics, per-epoch train/valid(/memory) tables,
named wall-clock timers, CSV rows.  Under data parallelism only rank 0
writes (``rank``).
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional, Sequence, TextIO

LOGO = r"""
   ____________________   _______________
  /   ___________   ___\ /___    ___\   |
  \___ \  ____\  \ /  /______\  \___ |  | SevenNet-FT
   ___\ \ \____\  v  /  ____  \  \___||  | (PyTorch / CUDA)
  /______\______\___/__/    \__\______|__|
"""


class Logger:
    def __init__(self, filename: Optional[str] = 'log.sevenn',
                 screen: bool = True, rank: int = 0):
        self.rank = rank
        self.screen = screen
        self.f: Optional[TextIO] = None
        if rank == 0 and filename:
            self.f = open(filename, 'w', buffering=1)
        self._timers: Dict[str, float] = {}
        self.csv_file: Optional[TextIO] = None
        self.csv_cols: Sequence[str] = ()

    def write(self, msg: str):
        if self.rank != 0:
            return
        if self.f:
            self.f.write(msg)
        if self.screen:
            sys.stdout.write(msg)
            sys.stdout.flush()

    def writeline(self, msg: str = ''):
        self.write(msg + '\n')

    def greeting(self):
        self.writeline(LOGO)

    def bar(self):
        self.writeline('-' * 78)

    def dict_of_config(self, config: Dict, title: str):
        self.bar()
        self.writeline(f'{title}:')
        for k, v in config.items():
            self.writeline(f'    {k:<34}: {v}')

    def statistics(self, stats: Dict[str, float], title: str = 'statistics'):
        self.bar()
        self.writeline(f'{title}:')
        for k, v in stats.items():
            self.writeline(f'    {k:<34}: {v}')

    def epoch_table(
        self,
        epoch: int,
        total_epoch: int,
        lr: float,
        sections: Dict[str, Dict[str, float]],
    ):
        """sections: {'Train': metrics, 'Valid': metrics, ...}"""
        self.bar()
        self.writeline(f'Epoch {epoch}/{total_epoch}  lr: {lr:8.6f}')
        keys = list(next(iter(sections.values())).keys())
        header = f'{"":<10}' + ''.join(f'{k:>22}' for k in keys)
        self.writeline(header)
        for name, metrics in sections.items():
            row = f'{name:<10}' + ''.join(
                f'{metrics.get(k, float("nan")):>22.6f}' for k in keys
            )
            self.writeline(row)

    # ---- timers ----
    def timer_start(self, name: str):
        self._timers[name] = time.time()

    def timer_end(self, name: str, msg: str = ''):
        dt = time.time() - self._timers.pop(name, time.time())
        self.writeline(f'{msg or name}: {dt:.2f} s')
        return dt

    # ---- csv ----
    def init_csv(self, path: str, columns: Sequence[str],
                 append: bool = False):
        if self.rank != 0:
            return
        self.csv_cols = list(columns)
        mode = 'a' if append else 'w'
        self.csv_file = open(path, mode, buffering=1)
        if not append:
            self.csv_file.write(','.join(self.csv_cols) + '\n')

    def append_csv(self, values: Dict[str, float]):
        if self.csv_file is None:
            return
        row = [str(values.get(c, '')) for c in self.csv_cols]
        self.csv_file.write(','.join(row) + '\n')

    def close(self):
        if self.f:
            self.f.close()
        if self.csv_file:
            self.csv_file.close()
