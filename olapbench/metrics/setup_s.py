"""Seconds from the start of the process to the start of the window:
imports, tables, catalog, kernel builds or loads, and warm-up."""


def read(run):
    return run.setup_s
