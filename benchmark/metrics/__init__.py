"""Readers of the per-layer metrics, one a metric's name (a dot in
the name is a folder: ``device.idle_pct`` is ``device/idle_pct.py``)."""
