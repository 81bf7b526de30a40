"""Workflow core: the typed pipeline API over an optimizable dataflow DAG."""

from keystone_tpu_torch.workflow.api import (  # noqa: F401
    Chainable,
    Estimator,
    FittedPipeline,
    GatherTransformerOperator,
    Pipeline,
    PipelineDataset,
    PipelineDatum,
    PipelineResult,
    Transformer,
)
from keystone_tpu_torch.workflow.executor import (  # noqa: F401
    GraphExecutor,
    PipelineEnv,
)
from keystone_tpu_torch.workflow.graph import (  # noqa: F401
    EMPTY_GRAPH,
    Graph,
    NodeId,
    SinkId,
    SourceId,
)
from keystone_tpu_torch.workflow.node_optimization import Optimizable  # noqa: F401
from keystone_tpu_torch.workflow.optimizer import DefaultOptimizer  # noqa: F401
