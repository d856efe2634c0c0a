"""LM serving session: continuous batching over a fixed slot grid (port of
``repro/serve/engine.py``).

A ``ServeSession`` owns a (L, B, S_max, ...) cache; requests occupy slots.
``add()`` prefills one request alone and splices its cache into a free
slot; ``step()`` decodes one token for every slot (greedy, or sampled at
``temperature > 0``); finished slots are freed and refilled.  The session
runs on ``device`` ("cuda" unless the caller passes "cpu") and raises when
CUDA is asked for and absent.  Encoder-decoder configs (whisper) are
refused, as in JAX: drive ``models.whisper``'s ``prefill`` and
``decode_step`` directly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import get_model, lm
from repro_torch.models.params import tree_map


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # int32 tokens
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_first: Optional[float] = None   # host clock at the first token
    t_done: Optional[float] = None    # host clock at the last token


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the "
                           "CPU")
    return dev


def _splice(big, one, slot):
    """Write a 1-row cache leaf (L, 1, ...) into row ``slot`` of the batched
    leaf (L, B, ...), zero-padding shorter dims at their end.  This takes
    the place of JAX's ``grow_cache`` then ``_splice``: one in-place write
    into the session's cache, with no grown copy."""
    row = big[:, slot]
    if tuple(one.shape[2:]) != tuple(row.shape[1:]):
        row.zero_()
    row[(slice(None),) + tuple(slice(0, s) for s in one.shape[2:])] = \
        one[:, 0]


class ServeSession:
    def __init__(self, cfg, params, batch_slots: int, max_len: int,
                 temperature: float = 0.0, seed: int = 0, device="cuda",
                 record_logits: bool = False):
        if cfg.enc_dec:
            raise ValueError(f"{cfg.name}: ServeSession serves decoder-only "
                             f"configs; drive an encoder-decoder through "
                             f"models.whisper's prefill and decode_step")
        self.model = get_model(cfg)
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, params
        self.B, self.S = batch_slots, max_len
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = lm.init_cache(cfg, batch_slots, max_len, self.device)
        self.k_len = np.zeros((batch_slots,), np.int32)
        self.last_tok = np.zeros((batch_slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * batch_slots
        # per-phase totals on the host clock (each phase ends in a host read
        # of its tokens, which waits for the device)
        self.stats = {"prefill_s": 0.0, "prefill_tokens": 0,
                      "decode_s": 0.0, "decode_tokens": 0, "steps": 0}
        # (slot or None for a decode step, f32 logits) per call, when asked
        self.logits_log = [] if record_logits else None

    # -- slot management ----------------------------------------------------
    def add(self, req: Request) -> bool:
        try:
            slot = self.active.index(None)
        except ValueError:
            return False
        Lp = len(req.prompt)
        if not 1 <= Lp < self.S:
            raise ValueError(f"prompt of {Lp} tokens does not fit a cache of "
                             f"{self.S}")
        t0 = time.perf_counter()
        toks = torch.as_tensor(np.asarray(req.prompt, np.int64),
                               device=self.device)[None]
        logits, cache1, _ = self.model.prefill(self.cfg, self.params,
                                               {"tokens": toks})
        tree_map(lambda big, one: _splice(big, one, slot), self.cache,
                 cache1)
        nxt = int(torch.argmax(logits[0]))
        now = time.perf_counter()
        self.stats["prefill_s"] += now - t0
        self.stats["prefill_tokens"] += Lp
        if self.logits_log is not None:
            self.logits_log.append((slot, logits[0].float().cpu().numpy()))
        self.k_len[slot] = Lp
        self.last_tok[slot] = nxt
        req.out.append(nxt)
        req.t_first = now
        self.active[slot] = req
        return True

    def step(self):
        """Decode one token for all active slots."""
        if not any(r is not None for r in self.active):
            return
        t0 = time.perf_counter()
        logits, self.cache = self.model.decode_step(
            self.cfg, self.params, self.cache,
            torch.as_tensor(self.last_tok, device=self.device),
            torch.as_tensor(self.k_len, device=self.device))
        if self.temperature > 0:
            probs = torch.softmax(logits.float() / self.temperature, -1)
            toks = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        else:
            toks = torch.argmax(logits, -1)
        toks = toks.cpu().numpy()
        now = time.perf_counter()
        self.stats["decode_s"] += now - t0
        self.stats["steps"] += 1
        if self.logits_log is not None:
            self.logits_log.append((None, logits.float().cpu().numpy()))
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            self.k_len[slot] += 1
            tok = int(toks[slot])
            req.out.append(tok)
            self.stats["decode_tokens"] += 1
            self.last_tok[slot] = tok
            if len(req.out) >= req.max_new or self.k_len[slot] >= self.S - 1:
                req.done = True
                req.t_done = now
                self.active[slot] = None

    def run(self, requests: List[Request], max_steps: int = 10_000):
        queue = list(requests)
        steps = 0
        while (queue or any(r is not None for r in self.active)) \
                and steps < max_steps:
            while queue and self.add(queue[0]):
                queue.pop(0)
            self.step()
            steps += 1
        return [r for r in requests if r.done]
