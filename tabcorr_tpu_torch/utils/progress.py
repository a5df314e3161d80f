"""Progress bars for the tabulation: tqdm where it is installed, else one
plain line on stderr a step.  Only what is displayed differs."""

from __future__ import annotations

import sys


def progress(iterable, total=None, desc=None, disable=False):
    """``iterable``, reporting one step for each item it yields (nothing
    where ``disable``)."""
    if disable:
        return iterable
    try:
        import tqdm
    except ImportError:
        return _lines(iterable, total, desc)
    return tqdm.tqdm(iterable, total=total, desc=desc, smoothing=0)


def _lines(iterable, total, desc):
    if total is None and hasattr(iterable, "__len__"):
        total = len(iterable)
    shown = "?" if total is None else total
    for i, item in enumerate(iterable, 1):
        yield item
        print(f"{desc or 'progress'}: {i}/{shown}", file=sys.stderr,
              flush=True)
