"""The benchmark of the PyTorch/CUDA port: TPC-H query streams through
``repro_torch``'s engine front door. ``python3 olapbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>``; see
README.md."""
