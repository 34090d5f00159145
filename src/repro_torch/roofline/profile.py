"""Per-op bytes and operations of one step, counted on meta tensors (the
JAX package's HLO profile, for the port): which ops and which model
functions dominate the memory term.

A row is an (aten op, tag, output shape), or a kernel's report
(``kernel:<name>``) at its input shapes; the tag is the innermost
``repro_torch.models`` function on the Python stack, read only while the
counter runs (``roofline.analysis.analyze_step(..., rows=True)``).  No
scope or ``record_function`` is added to the model code.
"""
from __future__ import annotations

from repro_torch.roofline.analysis import HW, analyze_step


def profile_step(fn, *args, top: int = 25, hw: HW = HW()) -> list:
    """The ``top`` rows of one run of ``fn(*args)`` by bytes, each with
    ``bytes``, ``flops`` (the kernels' reports) and ``count``."""
    rows = analyze_step(fn, *args, hw=hw, rows=True)["rows"]
    rows.sort(key=lambda r: -r["bytes"])
    return rows[:top] if top else rows


def print_profile(fn, *args, top: int = 25, hw: HW = HW()) -> list:
    rows = profile_step(fn, *args, top=0, hw=hw)
    total = sum(r["bytes"] for r in rows) or 1.0
    print(f"{'GB':>9} {'%':>5} {'x':>7}  op | shape | model function")
    for r in rows[:top]:
        print(f"{r['bytes']/1e9:9.3f} {100*r['bytes']/total:5.1f} "
              f"{r['count']:7.0f}  {r['op']:28s} {r['shape']:36s} "
              f"{r['tag']}")
    print(f"{total/1e9:9.3f} total GB")
    return rows[:top]
