"""Logical-plan compiler with pushdown-amenability analysis.

Port of ``repro.compiler`` (host-only):

- ``ir.py``          relational IR (Scan/Filter/Project/Map/Aggregate/
                     Join/SemiJoin/Shuffle/TopK/Sort/PyOp) over the port's
                     ``Expr`` predicates
- ``analyzer.py``    per-operator amenability classification
- ``splitter.py``    maximal storage frontier (lowered to ``PushPlan``)
                     + compute-side residual
- ``interpreter.py`` generic residual evaluator over
                     ``queryproc/operators.py``
- ``tpch_ir.py``     the 15 TPC-H queries as IR constructions
- ``multitable.py`` implied per-table predicates of multi-table filters,
                     and the §4.2 bitmap exchange they may lower to
- ``compile.py``     ``compile_query(qid)`` -> engine-ready ``Query``;
                     ``compile_query_costed`` picks each table's cut by
                     the cost model
- ``tensorize.py``   the residual as padded stage programs over device
                     tensors (``EngineConfig.residual="tensor"``)
"""
from repro_torch.compiler import (analyzer, interpreter, ir,  # noqa: F401
                                  multitable, splitter, tensorize)
from repro_torch.compiler.compile import (CompiledQuery,  # noqa: F401
                                          CutChoice, QUERY_IDS, compile_ir,
                                          compile_query,
                                          compile_query_costed,
                                          compile_query_detailed,
                                          substitute_fact_predicate)
from repro_torch.compiler.splitter import (CompileError,  # noqa: F401
                                           frontier_signature, frontier_size)
