"""Nirvana core — the paper's contribution.

Semantic-operator plan IR, selectivity cost model, NL transformation rules,
random-walk agentic logical optimizer (Alg. 1), LLM-as-a-judge execution-
consistency verifier, improvement-score physical optimizer (Alg. 2,
Eqs. 2-8 with evaluation pushdown / computation reuse / capability-
hypothesis approximation), backend tier cascade, plan executor, and the
SemanticDataFrame user API.
"""
from repro_torch.core.table import Table                                # noqa: F401
from repro_torch.core.plan import (LogicalPlan, Operator,               # noqa: F401
                             MAP, FILTER, REDUCE, RANK)
from repro_torch.core.cost import (DEFAULT_TIERS, TIER_ORDER, TierSpec,  # noqa: F401
                             plan_cost)
from repro_torch.core.backends import (Backend, SimulatedBackend,       # noqa: F401
                                 UsageMeter, Usage, make_backends,
                                 UDFOracle)
from repro_torch.core.improvement import (improvement_scores,          # noqa: F401
                                    OutputStore, ESTIMATORS)
from repro_torch.core.logical_optimizer import (LogicalOptConfig,       # noqa: F401
                                          optimize as optimize_logical,
                                          optimize_beam)
from repro_torch.core.physical_optimizer import (PhysicalOptConfig,     # noqa: F401
                                           optimize as optimize_physical,
                                           select_tier, smart_select)
from repro_torch.core.cascade import (CascadeBands, CascadeRouter,      # noqa: F401
                                EmbeddingBackend)
from repro_torch.core.runtime import (EventScheduler, ExecutionContext,  # noqa: F401
                                OutputCache, as_context)
from repro_torch.core.executor import execute, ExecutionResult          # noqa: F401
from repro_torch.core.dataframe import SemanticDataFrame, QueryReport   # noqa: F401
from repro_torch.core import judge, rewriter, rules, udf, semhash       # noqa: F401
