"""What the example scripts share: the ``--device`` flag and the wall of a
call, taken on the host's clock with the card's queue drained."""
from __future__ import annotations

import argparse
import time

import torch

from ..launch.steps import resolve_cli_device, sync_device


def device_from_argv(doc: str, argv=None) -> torch.device:
    """The device named by ``--device`` (``cuda``, the default, raises
    without a card; ``cpu``)."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    return resolve_cli_device(ap.parse_args(argv).device)


def timed(dev: torch.device, fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, its wall in seconds): ``time.perf_counter``
    around the call, the card synchronized before the clock starts and
    before it stops."""
    sync_device(dev)
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    sync_device(dev)
    return out, time.perf_counter() - t0
