"""Training (port of ``repro/train``): the LM loss, the train-step factory
and gradient compression.  The sharded dry run's ``abstract_state`` and
``state_logical`` wait for multi-GPU placement (ROADMAP queue 1 item 14)."""
from .loss import lm_loss  # noqa: F401
from .step import make_state, make_train_step, state_from_jax  # noqa: F401
from . import compress  # noqa: F401
