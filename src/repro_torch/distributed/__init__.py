"""The port's distributed pieces.

``workers`` (the multi-process storage tier) is not imported here: it
brings the multiprocessing and socket machinery that the in-process
engine does without. Import it by name::

    from repro_torch.distributed.workers import WorkerPool, pool_for
"""
