"""Training (port of ``repro/train``): the LM loss, the train-step factory
and gradient compression.  ``abstract_state`` and ``state_logical`` give
the state's shapes and logical axes, ``shard_state`` places a state on a
mesh (see ``step``)."""
from .loss import lm_loss  # noqa: F401
from .step import (abstract_state, loss_and_grads,  # noqa: F401
                   make_state, make_train_step, shard_state,
                   state_from_jax, state_logical)
from . import compress  # noqa: F401
