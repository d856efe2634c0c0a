"""Model zoo of the port: the generic decoder-only LM (``lm``, with the MoE
FFN and the multimodal prefix) and the whisper encoder-decoder
(``whisper``), dispatched by config.  ``get_model(cfg)`` returns the module,
or raises for a config that needs a part not ported yet."""
from __future__ import annotations

from . import layers, lm, mixers, moe, params, whisper  # noqa: F401

_PORTED_MIXERS = ("attn", "attn_local", "rwkv6")
_ITEM = "ROADMAP queue 1 item 15"


def get_model(cfg):
    missing = []
    if cfg.mtp:
        missing.append("multi-token prediction")
    missing += [f"the {k} mixer" for k in dict.fromkeys(cfg.pattern)
                if k not in _PORTED_MIXERS]
    if missing:
        raise NotImplementedError(
            f"model {cfg.name} needs {', '.join(missing)}, not ported yet: "
            f"{_ITEM}")
    return whisper if cfg.enc_dec else lm
