"""The yardstick of ``k1_roofline``: the least time an H100 could take for
a number of live DP cells, whatever implements the recurrence.

A configuration's file freezes its ``floor``: the fewest lane operations
any exact implementation could spend per live cell, each counted as one
instruction issue (``issues_per_cell``), how many cells one issued lane
instruction may cover (``cells_per_issue``: 2 where 16-bit pairs hold
every score, as Hopper's DPX instructions take them, so SW-Gotoh's 6.5
operations are 3.25 issues a cell), and the bytes each call must move
(``bytes_per_base`` of every live input character, ``bytes_per_pair`` of
lengths and results).  The peaks below are an H100 SXM's: 132 SMs at
their 1.98 GHz boost clock, each issuing at most four warp instructions a
clock (128 lane issues, the published f32 FMA rate as well), and 3.35 TB/s
of HBM3.  Integer add and max are published at 64 lanes a clock, but an
implementation that splits its adds between IMAD and IADD3 issues more,
so the floor takes every lane operation at the issue ceiling.

The bound is the larger of the issue time and the byte time; nothing here
reads the program's own cost model.
"""
from __future__ import annotations

SMS = 132
CLOCK_HZ = 1.98e9
LANE_ISSUES_PER_SM_CLOCK = 128
HBM_BYTES_PER_S = 3.35e12

LANE_ISSUES_PER_S = SMS * LANE_ISSUES_PER_SM_CLOCK * CLOCK_HZ


def issue_seconds(floor: dict, cells: int) -> float:
    """Seconds the card needs to issue the floor's instructions for
    ``cells`` live cells."""
    issues = cells * float(floor["issues_per_cell"]) / float(
        floor["cells_per_issue"])
    return issues / LANE_ISSUES_PER_S


def byte_seconds(floor: dict, bases: int, pairs: int) -> float:
    """Seconds HBM needs for the bytes the calls must move."""
    n = bases * float(floor["bytes_per_base"]) + pairs * float(
        floor["bytes_per_pair"])
    return n / HBM_BYTES_PER_S


def bound_seconds(floor: dict, cells: int, bases: int, pairs: int):
    """(seconds, which) of the floor: the larger of the two times."""
    t_ops = issue_seconds(floor, cells)
    t_bytes = byte_seconds(floor, bases, pairs)
    return (t_ops, "issues") if t_ops >= t_bytes else (t_bytes, "bytes")
