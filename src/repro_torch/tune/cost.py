"""Rank K1 schedule candidates without launching them (counterpart of
``repro.tune.cost``).

JAX ranks candidates by a roofline over their lowered HLO; K1 is a CUDA
kernel with no HLO, so the port ranks them by an analytic model of the H100
instead.  For one candidate ``{tb_pack, strip_warps}`` at a bucket and batch
the model takes the larger of two times:

  * the PE operations of the padded cells over the SMs' INT32 lanes,
    divided by the occupancy K1's shared memory (``kernel.smem_bytes`` at
    the candidate's warps) and the warps cap leave per SM;
  * the bytes K1 moves (``k1_bytes``: inputs read once, the pointer store
    at ``tb_pack`` and the per-lane bests written once) over HBM bandwidth;

and adds the strip pipeline's fill and drain: a pair's G warps start
``STRIP_LAG`` wavefronts apart, so about (G - 1) x STRIP_LAG wavefronts per
pair, per wave of resident pairs, run with warps idle.  The card's SM count,
shared memory and clock come from the device when one is given and present,
else from the stated H100 SXM description (``H100``), so the ranking also
runs on the CPU.  Only the top-K predicted candidates, plus always the
hand-picked default, go on to be timed (``search.tune_point``).

This module also holds the bound constants ``chip_smoke.py`` computes K1's
and K2's bounds with (one copy).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import subprocess
from typing import Optional

MEM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
INT32_LANES_PER_SM = 64            # Hopper: 4 partitions x 16 INT32 lanes
# int32 ALU operations of one PE cell, counted from the functors in
# src/repro_torch/kernels/wavefront/csrc/wavefront.cu (adds, maxes,
# compares, selects, pointer bit packing; local adds the zero clamp)
PE_OPS = {("linear", False): 11, ("linear", True): 14,
          ("affine", False): 21, ("affine", True): 24,
          ("two_piece", False): 39}
# operations per cell the ranking assumes for K1's other families (f32 and
# logsumexp PEs): every candidate of one spec shares it, so it sets only
# how compute weighs against bytes, not the order among warps counts
OTHER_PE_OPS = 32
# resident warps an SM needs to keep its INT32 lanes busy: four per
# scheduler to cover the dependent-ALU latency
WARPS_TO_SATURATE = 16
MAX_BLOCKS_PER_SM = 32


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """What the model needs of a card."""
    name: str
    sms: int
    smem_per_block: int            # opt-in dynamic shared memory per block
    smem_per_sm: int
    clock_hz: float


# H100 SXM5 (NVIDIA Hopper tuning guide and data sheet): 132 SMs, 228 KB
# shared memory per SM of which 227 KB per block, 1980 MHz max SM clock
H100 = DeviceModel("NVIDIA H100 80GB HBM3 (stated)", 132, 232448, 233472,
                   1.98e9)


@functools.lru_cache(maxsize=None)
def _max_sm_clock_hz(index: int) -> Optional[float]:
    """The card's maximum SM clock as ``nvidia-smi`` reports it (torch
    reports only the current clock), or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        return float(out.split()[0]) * 1e6
    except Exception:
        return None


def device_model(device=None) -> DeviceModel:
    """The model of ``device``'s card when it is a CUDA device that is
    present, else ``H100``.  Fields the device does not report keep
    H100's."""
    import torch
    if device is None or torch.device(device).type != "cuda" \
            or not torch.cuda.is_available():
        return H100
    dev = torch.device(device)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    props = torch.cuda.get_device_properties(index)
    return DeviceModel(
        props.name, props.multi_processor_count,
        getattr(props, "shared_memory_per_block_optin", H100.smem_per_block),
        getattr(props, "shared_memory_per_multiprocessor", H100.smem_per_sm),
        _max_sm_clock_hz(index) or H100.clock_hz)


def pe_ops(spec, params=None) -> int:
    """Operations of one PE cell: ``PE_OPS`` for the int32 gap models,
    ``OTHER_PE_OPS`` for K1's other hand-written families, and for a PE
    K1 generates (``kernels/wavefront/synth.py``) the generated functor's
    own count (``Synth.ops``: the live statements of its cell, each
    weighted by what the card needs for it; the functor of ``params``'
    signature, or of the probe parameters without them)."""
    from repro_torch.kernels.wavefront import kernel as K1
    if K1.is_generated(spec):
        syn = (K1.synth.lower(spec, params) if params is not None
               else K1.synth.probe(spec))
        return syn.ops
    fam = spec.family
    return PE_OPS.get((fam.family, bool(fam.local)), OTHER_PE_OPS)


def k1_bytes(spec, batch: int, q_bucket: int, r_bucket: int, tb_pack: int,
             with_tb: bool = True) -> int:
    """Bytes one K1 launch must move: the query and reference characters,
    the init row and column, the lengths, the ``('chunk', 32, tb_pack)``
    pointer store and the per-lane best and best_j, each once."""
    from repro_torch.kernels.wavefront import kernel as K1
    B, L = int(batch), spec.n_layers
    bq, br = -(-int(q_bucket) // K1.N_PE) * K1.N_PE, int(r_bucket)
    C, cb = bq // K1.N_PE, K1.char_bytes(spec)
    sz = spec.score_dtype.itemsize
    tb = B * C * (K1.N_PE // tb_pack) * (K1.N_PE + br - 1) if with_tb else 0
    return (B * bq * cb + B * br * cb + B * (br + 1) * L * sz
            + B * (bq + 1) * L * sz + B * 8                       # inputs
            + tb + B * C * K1.N_PE * (sz + 4))            # store, best, j


def point_cells(bucket: tuple, batch_size: Optional[int]) -> float:
    """DP cells one dispatch fills at this point (padded bucket area,
    shared by every candidate)."""
    return float(bucket[0]) * float(bucket[1]) * float(batch_size or 1)


def predict(spec, bucket: tuple, batch_size: Optional[int], options: dict,
            *, with_tb: bool = True,
            model: Optional[DeviceModel] = None) -> dict:
    """The model's time for one K1 candidate (see the module docstring):
    ``seconds`` (inf when the warps' shared memory exceeds the card's
    per-block limit) and its parts."""
    from repro_torch.kernels.wavefront import kernel as K1
    m = model or H100
    B = int(batch_size or 1)
    Q = -(-int(bucket[0]) // K1.N_PE) * K1.N_PE
    R = int(bucket[1])
    pack = int(options.get("tb_pack") or 1)
    G = options.get("strip_warps")
    G = K1.strip_warps(Q, B, m.sms) if G is None else int(G)
    smem = K1.smem_bytes(spec, Q, R, G, with_tb)
    out = {"warps": G, "smem_bytes": smem}
    if smem > m.smem_per_block:
        return {**out, "seconds": math.inf}
    per_sm = min(m.smem_per_sm // smem, K1.WARPS_PER_SM // G,
                 MAX_BLOCKS_PER_SM, -(-B // m.sms))
    resident = per_sm * G
    occupancy = min(1.0, resident / WARPS_TO_SATURATE)
    ops = pe_ops(spec) * float(B) * Q * R
    lane_rate = m.sms * INT32_LANES_PER_SM * m.clock_hz
    compute_s = ops / lane_rate / occupancy
    bytes_s = k1_bytes(spec, B, Q, R, pack, with_tb) / MEM_BYTES_PER_S
    waves = -(-B // (m.sms * per_sm))
    # one wavefront of one warp while the SM's resident warps share its
    # lanes
    wavefront_s = (pe_ops(spec) * K1.N_PE * max(resident, WARPS_TO_SATURATE)
                   / (INT32_LANES_PER_SM * m.clock_hz))
    fill_s = waves * (G - 1) * K1.STRIP_LAG * wavefront_s
    return {**out, "blocks_per_sm": per_sm, "occupancy": occupancy,
            "compute_s": compute_s, "bytes_s": bytes_s, "fill_s": fill_s,
            "seconds": max(compute_s, bytes_s) + fill_s}


def rank(spec, params, engine_name: str, bucket: tuple,
         batch_size: Optional[int], candidates: list, *,
         default: Optional[dict] = None, top_k: int = 4,
         with_traceback: bool = True, mode: str = "align", log=None,
         device=None) -> tuple[list, list]:
    """Split candidates into (kept, pruned) by predicted time, fastest
    first.

    Each element is ``{"options", "predicted_s", "predicted_cells_per_s"}``;
    the default point is always kept (appended if the model ranked it out)
    and pruned points go to ``log``, so a sweep's coverage cut is visible.
    A point the card cannot launch predicts inf and ranks last.  Engines
    without K1 (nothing the model describes) predict nan and keep their
    order.  ``params`` is part of JAX's signature; the model does not read
    it."""
    from repro_torch.runtime import registry
    model = device_model(device)
    with_tb = bool(mode == "fill" or (with_traceback
                                      and spec.traceback is not None))
    cells = point_cells(bucket, batch_size)
    def score(cand):
        secs = math.nan
        if registry.engine_fill(engine_name, cand) == registry.K1_FILL:
            secs = predict(spec, bucket, batch_size, cand, with_tb=with_tb,
                           model=model)["seconds"]
        return {"options": dict(cand), "predicted_s": secs,
                "predicted_cells_per_s": cells / secs
                if secs and not math.isnan(secs) else math.nan}

    scored = sorted((score(c) for c in candidates),
                    key=lambda s: (math.isnan(s["predicted_s"]),
                                   s["predicted_s"]))
    n = max(top_k, 1)
    kept, pruned = scored[:n], scored[n:]
    if default is not None and \
            not any(s["options"] == default for s in kept):
        rescued = next((s for s in pruned if s["options"] == default), None)
        if rescued is not None:
            pruned.remove(rescued)
        kept.append(rescued or score(default))
    if log is not None:
        for s in pruned:
            log(f"pruned {s['options']} (predicted "
                f"{s['predicted_s'] * 1e3:.4g} ms)")
    return kept, pruned
