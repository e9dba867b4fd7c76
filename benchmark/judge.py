"""The limits that decide ``correct``: ``benchmark/limits/<workload>.json``
holds, for each number a cell compares, the limit set from the readings
of sound runs and of the control (``PERF.md`` gives both)."""

from __future__ import annotations

import json
import math
from typing import Dict


def judge(ctx, readings: Dict[str, float]):
    """(correct, {number: {value, limit}}): every number that has a limit
    finite and at or under it.  A reading without a limit (one that no
    control separates from sound runs) is logged, not compared."""
    with open(ctx.bench_dir / 'limits' / f'{ctx.cell["name"]}.json') as f:
        limits = json.load(f)['limits']
    missing = [k for k in limits if k not in readings]
    if missing:
        raise KeyError(f'no reading for the limits {missing}')
    for k in sorted(set(readings) - set(limits)):
        ctx.log(f'[bench] not compared: {k} {readings[k]:.6e}')
    checks = {k: {'value': float(readings[k]), 'limit': float(limits[k])}
              for k in limits}
    ok = all(math.isfinite(c['value']) and c['value'] <= c['limit']
             for c in checks.values())
    return ok, checks
