"""Model zoo of the port: the generic decoder-only LM (``lm``) over the
ported mixers.  ``get_model(cfg)`` returns it, or raises for a config that
needs a module not ported yet."""
from __future__ import annotations

from . import layers, lm, mixers, params  # noqa: F401

_PORTED_MIXERS = ("attn", "attn_local", "rwkv6")
_ITEM = "ROADMAP queue 1 item 15"


def get_model(cfg):
    missing = []
    if cfg.enc_dec:
        missing.append("the encoder-decoder (whisper)")
    if cfg.frontend:
        missing.append(f"the {cfg.frontend} frontend")
    if cfg.mtp:
        missing.append("multi-token prediction")
    if cfg.n_experts:
        missing.append("MoE")
    missing += [f"the {k} mixer" for k in dict.fromkeys(cfg.pattern)
                if k not in _PORTED_MIXERS]
    if missing:
        raise NotImplementedError(
            f"model {cfg.name} needs {', '.join(missing)}, not ported yet: "
            f"{_ITEM}")
    return lm
