"""Entry modules: each traffic mix names one (`"entry"` in its data file),
which builds the program for the cell, warms the shapes the mix uses,
drives the measured window and hands the served outputs to the check.

An entry module has `setup(run)`, `window(run)`, `counters(run)` and
`release(run)`; what they share is in `common.py`.
"""
