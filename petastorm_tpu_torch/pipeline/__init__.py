"""Explicit pipeline stage graph and profile-driven online autotuner (the
port's own copy of ``petastorm_tpu/pipeline``).

``graph.py`` models the reader / loader stack as stage nodes with
placements and measured costs; ``autotune.py`` plans knob changes from
windowed profiles (pure) and applies them live. Entry points:
``build_loader_graph(loader)`` and ``make_torch_dataloader(...,
autotune=...)``.
"""

from petastorm_tpu_torch.pipeline.autotune import (  # noqa: F401
    AutotuneController,
    Planner,
    classify,
)
from petastorm_tpu_torch.pipeline.graph import (  # noqa: F401
    Knob,
    PipelineGraph,
    StageNode,
    build_loader_graph,
)
