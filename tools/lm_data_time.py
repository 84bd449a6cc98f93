#!/usr/bin/env python3
"""Seconds a batch of ``SyntheticLM.batch_at`` (the train driver's data) on
this host: the Gumbel draws on threads, as the driver runs them, against
the same batch drawn in order (``PARALLEL_MIN`` raised past the batch),
and whether the two batches' tokens are equal.

    python3 tools/lm_data_time.py [--sizes 32768:8 49155:4 256000:2]
                                  [--seq 256] [--repeats 2]

Each ``--sizes`` item is ``vocab:batch``: the defaults are the example's
``gemma2-100m`` (B 8), ``granite-moe-1b-a400m`` (B 4) and ``gemma2-2b``
(B 2) as the smoke trains them.  Host only; needs no card.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    from repro_torch.data import lm_data
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", nargs="+",
                    default=["32768:8", "49155:4", "256000:2"])
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)
    ok = True
    for item in args.sizes:
        V, B = (int(x) for x in item.split(":"))
        data = lm_data.SyntheticLM(V, args.seq, B, seed=0)
        threaded = []
        for step in range(args.repeats):
            t0 = time.perf_counter()
            got = data.batch_at(step)
            threaded.append(time.perf_counter() - t0)
        floor = lm_data.PARALLEL_MIN
        lm_data.PARALLEL_MIN = 1 << 62
        try:
            t0 = time.perf_counter()
            want = data.batch_at(args.repeats - 1)
            in_order = time.perf_counter() - t0
        finally:
            lm_data.PARALLEL_MIN = floor
        equal = all(bool((got[k] == want[k]).all()) for k in want)
        ok &= equal
        print(f"[lm-data] V {V} B {B} S {args.seq}: threaded "
              f"{[round(t, 3) for t in threaded]} s a batch, in order "
              f"{in_order:.3f} s; tokens equal {equal}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
