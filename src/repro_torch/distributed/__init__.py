"""The port's distributed pieces (port of ``repro.distributed``).

``sharding`` (logical axes -> DTensor placements) is imported here, as the
reference imports its own. ``workers`` (the multi-process storage tier) is
not: it brings the multiprocessing and socket machinery that the
in-process engine does without. Import it by name::

    from repro_torch.distributed.workers import WorkerPool, pool_for
"""
from repro_torch.distributed import sharding  # noqa: F401
