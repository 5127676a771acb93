"""The plain reference of each TPC-H query the mixes send, one file a
query, named by its id: ``reference(T, F)`` works the query out in plain
PyTorch from the benchmark's own tables (``refops.RefTables``), with the
fixed parameters of ``repro_torch/queryproc/queries.py`` (the TPC-H
query text's, with the generator's dictionary codes), and returns the
result's columns under the program's names. ``F`` is the float type it
computes in."""
