"""K1: the wavefront matrix-fill kernel for Hopper, its launcher and its
plain PyTorch version (port of ``repro/kernels/wavefront/kernel.py``).

``wavefront_fill`` takes a batch of pairs whose query is padded to the
32-row lane strip and whose boundary row and column are already masked by
effective length and band (``ops.run`` prepares them), and returns the
per-(pair, strip, lane) best score, its first column, and the
``('chunk', 32, pack)`` pointer store.  A CUDA tensor goes to the CUDA
kernel in ``csrc/wavefront.cu``; a CPU tensor goes to
``wavefront_fill_plain``.  Nothing falls back from one to the other.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core import types as T
from repro_torch.core.spec_utils import band_mask, region_mask
from repro_torch.core.traceback import pack_lanes

N_PE = 32               # lanes per strip: one warp, one lane per PE
STRIP_WARPS = 8         # most warps per pair: strips in flight at once
WARPS_PER_SM = 32       # K1's resident warps per SM (64 registers a thread)
# Strip c + 1 uses column x of strip c's bottom row at wavefront x - 1,
# and strip c's lane 31 writes it at wavefront x + 30: the least number of
# wavefronts by which a strip may trail the one above it.  The CUDA code
# mirrors it (it signals a handoff chunk after wavefront
# RING_CHUNK (k + 1) + STRIP_LAG - 2) and the launch checks that the two
# agree.
STRIP_LAG = N_PE
RING_CHUNK = 16         # columns per handoff chunk (CH in the CUDA code)
TILE_STRIDE = 36        # bytes per wavefront of a warp's pointer tile
REF_PAD = 32            # slack bytes each side of the staged reference
SOURCE = Path(__file__).resolve().parent / "csrc" / "wavefront.cu"

FAMILY_IDS = {T.FAMILY_LINEAR: 0, T.FAMILY_AFFINE: 1, T.FAMILY_TWO_PIECE: 2}
REGION_IDS = {T.REGION_CORNER: 0, T.REGION_ALL: 1, T.REGION_LAST_ROW: 2,
              T.REGION_LAST_ROW_COL: 3}
_PARAM_NAMES = ("match", "mismatch", "gap", "gap_open", "gap_extend",
                "gap_open2", "gap_extend2")

# CUDA kernel launches since import (or since a caller reset it to 0); the
# plain version does not count.
launches = 0


def supports(spec: T.DPKernelSpec):
    """None when K1 can fill ``spec``, else the reason it cannot."""
    if spec.objective != "max" or spec.score_dtype != torch.int32:
        return f"kernel {spec.name}: K1 implements int32 max-plus only"
    if spec.family is None:
        return f"kernel {spec.name} has no compiled PE family yet"
    if spec.primary_layer != 0 or spec.char_shape != ():
        return f"kernel {spec.name}: K1 scores layer 0 of scalar codes"
    return None


def strip_warps(q_bucket: int, batch: int, sms: int) -> int:
    """Warps per pair (per thread block): up to STRIP_WARPS, halved while
    the batch's warps would exceed what ``sms`` SMs hold at once (a strip
    pipeline idles its warps for a few chunks at each end, so fewer warps
    a pair and more pairs resident fill the card better), never below 2
    where the pair has two strips."""
    c = max(1, int(q_bucket) // N_PE)
    g = min(c, STRIP_WARPS)
    while g > 2 and int(batch) * g > sms * WARPS_PER_SM:
        g //= 2
    return g


def ring_chunks(r_bucket: int, warps: int) -> int:
    """Slots of each handoff ring, a power of two.

    A warp runs its strips in order, so when the lowest unfinished strip
    m runs, the warp of strip m + G (G warps) is still busy with it, and
    strip m + G - 1 can hand over at most NCH chunks before it waits.  Each
    strip above m then runs at most NCH chunks ahead of the one below it
    (a strip blocked on chunk p has released the p chunks it read), so
    strip m can write G * NCH chunks: with NCH >= ceil(chunks / G) + 1 it
    never waits on a strip that cannot start.  Four slots otherwise keep
    a producer clear of its consumer."""
    chunks = -(-int(r_bucket) // RING_CHUNK)
    need = max(4, -(-chunks // warps) + 1)
    return 1 << (need - 1).bit_length()


# Score layers each PE family reads from the cell above, by its layer
# count (H; H and D for affine; H, D1 and D2 for two-piece): the layers K1
# shuffles between lanes and holds in the handoff rings (PE::UP in
# csrc/wavefront.cu).  Every family reads only H from the diagonal.
UP_LAYERS = {1: (0,), 3: (0, 2), 5: (0, 2, 4)}


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def smem_bytes(spec: T.DPKernelSpec, q_bucket: int, r_bucket: int,
               warps: int, with_tb: bool = True) -> int:
    """Dynamic shared memory of one K1 thread block (one pair), laid out
    as ``csrc/wavefront.cu::layout``: the rings' mbarriers (full and empty
    per slot), the substitution matrix for matrix-scored kernels (at most
    24 x 24), the handoff rings (warps x slots x RING_CHUNK columns x up
    layers), the init row's up layers, a 32-wavefront pointer tile per
    warp, and the pair's query and reference codes (the latter with
    REF_PAD bytes each side)."""
    q, r, g = int(q_bucket), int(r_bucket), int(warps)
    nch = ring_chunks(r, g)
    nu = len(UP_LAYERS[spec.n_layers])
    sub = 24 * 24 * 4 if spec.family and spec.family.sub == T.SUB_MATRIX \
        else 0
    return (_align16(g * nch * 2 * 8) + _align16(sub)
            + _align16(g * nch * RING_CHUNK * nu * 4)
            + _align16((r + 1) * nu * 4)
            + (g * N_PE * TILE_STRIDE if with_tb else 0)
            + _align16(q) + _align16(r + 2 * REF_PAD))


def _check_inputs(spec, query, ref, init_row, init_col, lens, tb_pack):
    reason = supports(spec)
    if reason:
        raise ValueError(reason)
    if tb_pack not in (1, 2, 4, 8):
        raise ValueError(f"tb_pack must be 1, 2, 4 or 8, got {tb_pack}")
    if query.dim() != 2 or ref.dim() != 2:
        raise ValueError("query and ref must be (batch, length)")
    B, Q = query.shape
    R = ref.shape[1]
    L = spec.n_layers
    if Q % N_PE:
        raise ValueError(f"query length {Q} is not a multiple of {N_PE}")
    if R < 1:
        raise ValueError("reference bucket must be at least 1")
    want = {"query": (query, torch.uint8, (B, Q)),
            "ref": (ref, torch.uint8, (B, R)),
            "init_row": (init_row, torch.int32, (B, R + 1, L)),
            "init_col": (init_col, torch.int32, (B, Q + 1, L)),
            "lens": (lens, torch.int32, (B, 2))}
    for name, (t, dt, shape) in want.items():
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != query.device:
            raise ValueError(f"{name} is on {t.device}, query on "
                             f"{query.device}")


def wavefront_fill(spec: T.DPKernelSpec, params, query, ref, init_row,
                   init_col, lens, tb_pack: int = 1, with_tb: bool = True):
    """Fill a batch of pairs.

    query (B, Q) uint8 with Q a multiple of 32; ref (B, R) uint8; init_row
    (B, R + 1, L) and init_col (B, Q + 1, L) int32, masked; lens (B, 2)
    int32 effective lengths.  Returns ``(tb, best, best_j)``: tb
    (B, Q/32, 32/tb_pack, 32 + R - 1) uint8 (None when ``with_tb`` is
    False), best and best_j (B, Q/32, 32) int32.
    """
    _check_inputs(spec, query, ref, init_row, init_col, lens, tb_pack)
    if query.device.type == "cpu":
        return wavefront_fill_plain(spec, params, query, ref, init_row,
                                    init_col, lens, tb_pack, with_tb)
    if query.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not "
                         f"{query.device}")
    return _launch(spec, params, query.contiguous(), ref.contiguous(),
                   init_row.contiguous(), init_col.contiguous(),
                   lens.contiguous(), tb_pack, with_tb)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        from repro_torch.kernels import build
        lib = build.load(SOURCE).lib
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.wavefront_fill_launch.argtypes = (
            [i] * 5 + [p] * 6 + [i] + [i] * 7 + [p] * 3 + [i] * 9 + [p])
        lib.wavefront_fill_launch.restype = i
        lib.wavefront_max_smem.argtypes = [i]
        lib.wavefront_max_smem.restype = i
        _LIB = lib
    return _LIB


def _launch(spec, params, query, ref, init_row, init_col, lens, tb_pack,
            with_tb):
    global launches
    lib = _lib()
    dev = query.device
    B, Q = query.shape
    R = ref.shape[1]
    C = Q // N_PE
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    limit = lib.wavefront_max_smem(index)
    warps = strip_warps(Q, B, torch.cuda.get_device_properties(
        index).multi_processor_count)
    need = smem_bytes(spec, Q, R, warps, with_tb)
    if need > limit:
        raise ValueError(
            f"kernel {spec.name}: reference bucket {R} needs "
            f"{need} bytes of shared memory per block; this "
            f"device allows {limit}")
    fam = spec.family
    matrix = fam.sub == T.SUB_MATRIX
    sub = (params["sub"].to(device=dev, dtype=torch.int32).contiguous()
           if matrix else None)
    n_sub = sub.shape[0] if matrix else 0
    if matrix and (sub.dim() != 2 or sub.shape != (n_sub, n_sub)
                   or n_sub > 24):
        raise ValueError("substitution matrix must be square, at most 24")
    vals = [int(params.get(k, 0)) for k in _PARAM_NAMES]
    # the kernel writes every byte of the store, zeros included
    tb = (torch.empty((B, C, N_PE // tb_pack, N_PE + R - 1),
                      dtype=torch.uint8, device=dev) if with_tb else None)
    best = torch.empty((B, C, N_PE), dtype=torch.int32, device=dev)
    best_j = torch.empty((B, C, N_PE), dtype=torch.int32, device=dev)
    band = -1 if spec.band is None else int(spec.band)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wavefront_fill_launch(
            FAMILY_IDS[fam.family], int(matrix), int(fam.local),
            REGION_IDS[spec.region], band,
            query.data_ptr(), ref.data_ptr(), init_row.data_ptr(),
            init_col.data_ptr(), lens.data_ptr(),
            sub.data_ptr() if matrix else None, n_sub, *vals,
            tb.data_ptr() if with_tb else None, best.data_ptr(),
            best_j.data_ptr(), B, Q, R, tb_pack, int(with_tb), warps,
            ring_chunks(R, warps).bit_length() - 1, STRIP_LAG, RING_CHUNK,
            stream)
    if err:
        raise RuntimeError(f"K1 wavefront_fill launch failed: CUDA error "
                           f"{err} (kernel {spec.name}, Q={Q}, R={R}, "
                           f"batch {B})")
    launches += 1
    return tb, best, best_j


def wavefront_fill_plain(spec: T.DPKernelSpec, params, query, ref, init_row,
                         init_col, lens, tb_pack: int = 1,
                         with_tb: bool = True):
    """Plain PyTorch version of ``wavefront_fill``: same arguments, same
    outputs bit for bit.

    It sweeps whole anti-diagonals over every query row at once (the strips
    of the kernel run skewed by 32 wavefronts, so they advance together and
    the row buffer becomes a plain shift between neighbouring rows), keeps
    the pointers of the swept matrix, and rearranges them into the
    ``('chunk', 32, pack)`` store at the end.  Each row keeps its best over
    the objective region with a strict better-than, so the first column
    wins, as in the kernel.
    """
    B, Q = query.shape
    R = ref.shape[1]
    L = spec.n_layers
    dev = query.device
    sent = spec.sentinel()
    i32 = torch.int32
    q_len = lens[:, 0:1]
    r_len = lens[:, 1:2]
    rows = torch.arange(1, Q + 1, dtype=i32, device=dev)          # (Q,)
    q_chars = query.reshape(-1)
    i_flat = rows.repeat(B)

    # anti-diagonal buffers over rows 0..Q: buf[:, i] = cell (i, d - i);
    # the corner cell (0, 0) comes from the init row, as in the kernel
    def boundary(d):
        buf = torch.full((B, Q + 1, L), sent, dtype=i32, device=dev)
        if d <= R:
            buf[:, 0] = init_row[:, d]
        if 1 <= d <= Q:
            buf[:, d] = init_col[:, d]
        return buf

    prev2 = torch.full((B, Q + 1, L), sent, dtype=i32, device=dev)
    prev = boundary(0)
    ptrs = torch.zeros((B, Q, R), dtype=torch.uint8, device=dev)
    best = torch.full((B, Q), sent, dtype=i32, device=dev)
    best_j = torch.zeros((B, Q), dtype=i32, device=dev)
    last = min(Q + R, int((lens[:, 0] + lens[:, 1]).max()) if B else 0)
    for d in range(1, last + 1):
        j = d - rows                                              # (Q,)
        r_chars = ref[:, (j - 1).clamp(0, R - 1).long()].reshape(-1)
        up = prev[:, :-1].reshape(-1, L)
        left = prev[:, 1:].reshape(-1, L)
        diag = prev2[:, :-1].reshape(-1, L)
        scores, ptr = spec.pe(params, q_chars, r_chars, diag, up, left,
                              i_flat, j.repeat(B))
        scores = scores.to(i32).reshape(B, Q, L)
        ptr = ptr.reshape(B, Q)
        valid = (j >= 1) & (j <= r_len) & (rows <= q_len) & \
            band_mask(spec, rows, j)                              # (B, Q)
        cur = boundary(d)       # invalid cells keep the boundary/sentinel
        cur[:, 1:] = torch.where(valid[..., None], scores, cur[:, 1:])
        in_store = (j >= 1) & (j <= R)
        ii = rows[in_store] - 1
        ptrs[:, ii, (j[in_store] - 1).long()] = torch.where(
            valid, ptr, 0).to(torch.uint8)[:, ii]
        cand = torch.where(region_mask(spec, rows, j, q_len, r_len),
                           cur[:, 1:, spec.primary_layer], sent)
        upd = cand > best
        best = torch.where(upd, cand, best)
        best_j = torch.where(upd, j, best_j)
        prev2, prev = prev, cur

    C = Q // N_PE
    tb = None
    if with_tb:
        WT = N_PE + R - 1
        lanes = ptrs.reshape(B, C, N_PE, R)
        store = torch.zeros((B, C, N_PE, WT), dtype=torch.uint8, device=dev)
        for lane in range(N_PE):
            store[:, :, lane, lane:lane + R] = lanes[:, :, lane]
        tb = pack_lanes(store.transpose(2, 3), tb_pack).transpose(2, 3)
        tb = tb.contiguous()
    return tb, best.reshape(B, C, N_PE), best_j.reshape(B, C, N_PE)
