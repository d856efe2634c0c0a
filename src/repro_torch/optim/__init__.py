"""AdamW and the learning-rate schedules (port of ``repro/optim``).  The
sharded dry run's ``abstract_state`` and ``state_logical`` wait for
multi-GPU placement (ROADMAP queue 1 item 14)."""
from .adamw import AdamWConfig, init_state, update  # noqa: F401
from .schedules import constant, cosine_with_warmup  # noqa: F401
