"""AdamW and the learning-rate schedules (port of ``repro/optim``).
``abstract_state`` and ``state_logical`` give the moments' shapes and
logical axes for placement on a mesh (``launch.shardctx``)."""
from .adamw import (AdamWConfig, abstract_state, init_state,  # noqa: F401
                    state_logical, update)
from .schedules import constant, cosine_with_warmup  # noqa: F401
