"""The launch plans of the lattice kernels on ``csrc/lattice.cuh``'s
skeleton: the backwards K4 (``csrc/ctc_bwd.cu``) and K8b
(``csrc/star_bwd.cu``), shared by ``ops/ctc_cuda.plan`` and
``ops/star_cuda.plan`` (``plan``), and the forwards K3
(``csrc/ctc_fwd.cu``, ``ops/ctc_cuda.fwd_plan``) and K8a
(``csrc/star_fwd.cu``, ``ops/star_cuda.fwd_plan``), both on
``forward_plan``; pure Python, so the CPU tests hold them.

One block an utterance (``csrc/lattice_bwd.cuh``): ``sweep_warps`` warps
(at most ``SWEEP_WARPS``) run the reverse beta sweep, lane l owning the
contiguous states l K .. l K + K - 1 in registers (K = ``per_lane``);
``scatter_warps`` warps bring each frame's alpha history and gathered emissions into a
shared-memory ring ahead of the sweep, and turn its betas into d em and
the gradient row, with fixed-order class sums, behind it. The ring has
``depth`` slots of ``frames`` frames (em, alpha and beta rows of K x 32
x ``sweep_warps`` floats, state s = l K + j at j * LANES + l); the sweep
meets its mbarriers once a slot. A ``dense`` plan stages a slot's
gradient rows in shared memory and copies them out whole; where C is too
wide for that, the class sums go straight to the gradient and the empty
columns get zeros. ``smem`` is the block's dynamic shared memory, byte
for byte the layout of ``lattice_bwd.cuh`` (``hl::lat::layout``); the
launcher refuses a plan whose size differs.
"""

import functools
from typing import NamedTuple

MAX_STATES = 4096       # 32 states a lane over a warpgroup's 128 lanes
SMEM_LIMIT = 232448     # bytes of shared memory a block may use (H100)
SWEEP_WARPS = 4         # a warpgroup: one warp on each SM sub-partition
PER_LANE = (2, 4, 8, 16, 32)   # the kernels' instantiations of K
LONG = 4                # a class of more states is summed by a warp
# (frames a slot, slots), the first that fits: up to 16 frames in flight;
# the scatter warps' two groups take alternate slots (even depths)
RINGS = ((4, 4), (4, 2), (2, 2), (1, 2))
GROUPS = 2
MAX_WARPS = 12          # sweep + scatter warps of a block


def max_warps(K):
    """The kernels' launch bound: 12 warps, 8 from 16 states a lane (which
    want the registers)."""
    return 8 if K >= 16 else MAX_WARPS


class Plan(NamedTuple):
    states: int         # S
    classes: int        # C (CTC) or 2V (Star-CTC)
    per_lane: int       # K: states a sweep lane owns
    sweep_warps: int
    scatter_warps: int
    frames: int         # frames a ring slot
    depth: int          # ring slots
    dense: bool         # a slot's gradient rows staged in shared memory
    smem: int           # bytes of dynamic shared memory
    threads: int        # 32 x (sweep_warps + scatter_warps)

    @property
    def lanes(self):
        return 32 * self.sweep_warps

    @property
    def slot(self):
        return self.per_lane * self.lanes


def owner(p, s):
    """(sweep lane, register index) of state ``s``."""
    return divmod(s, p.per_lane)


def address(p, s):
    """State ``s``'s place in a ring slot (lattice_bwd.cuh addr_of)."""
    lane, j = owner(p, s)
    return j * p.lanes + lane


def _align16(x):
    return (x + 15) // 16 * 16


def smem_bytes(S, C, K, sweep_warps, frames, depth, dense):
    """hl::lat::layout(...).bytes: mbarriers, edge exchange, the long and
    the short classes, class starts, order, each state's class, a slot's
    gradient rows (dense plans), then the ring."""
    slot = K * 32 * sweep_warps
    return (_align16(3 * depth * 8) + _align16(2 * sweep_warps * 8 * 4) +
            _align16((S // (LONG + 1) + 2) * 4) + _align16((S + 1) * 4) +
            _align16((C + 1) * 4) + _align16(S * 4) + _align16(S * 4) +
            (_align16(GROUPS * 2 * frames * C * 4) if dense else 0) +
            depth * 3 * frames * slot * 4)


def scatter_warps(C, K):
    """8 scatter warps where a sweep lane holds 2 states, 4 where it holds
    more or C <= 256 (one-call timings on the H100: K4 at lstm:512's
    lattice 0.144 ms with 8, 0.157 with 4; K8b 0.252 with 8, 0.246 with
    4: the heavier sweep wants its sub-partitions)."""
    return 4 if C <= 256 or K >= 4 else 8


@functools.lru_cache(maxsize=256)
def plan(S, C, min_per_lane, name):
    """The launch of a backward lattice of ``S`` states and ``C`` classes:
    the least K of ``PER_LANE`` (at least ``min_per_lane``) with which at
    most ``SWEEP_WARPS`` warps hold the states, only the warps that own
    states, ``scatter_warps(C, K)`` scatter warps, and the first ring of
    ``RINGS`` that fits in ``SMEM_LIMIT`` with the rows staged, else
    without. Raises ValueError where no such plan exists; ``name`` is the
    caller's, for the message."""
    if S < 1 or C < 1:
        raise ValueError(f"{name}: {S} states, {C} classes")
    cap = min(MAX_STATES, 32 * SWEEP_WARPS * PER_LANE[-1])
    if S > cap:
        raise ValueError(f"{name}: {S} lattice states exceed the kernel's "
                         f"{cap}")
    K = next(k for k in PER_LANE
             if k >= min_per_lane and 32 * SWEEP_WARPS * k >= S)
    warps = -(-(-(-S // K)) // 32)
    scatter = scatter_warps(C, K)
    if scatter % GROUPS or warps + scatter > max_warps(K):
        raise ValueError(f"{name}: {warps} + {scatter} warps exceed "
                         f"{max_warps(K)}")
    for dense in (True, False):
        for frames, depth in RINGS:
            smem = smem_bytes(S, C, K, warps, frames, depth, dense)
            if smem <= SMEM_LIMIT:
                return Plan(S, C, K, warps, scatter, frames, depth, dense,
                            smem, 32 * (warps + scatter))
    raise ValueError(f"{name}: a {C}-class row with {S} states does not "
                     f"fit in shared memory ({SMEM_LIMIT} bytes)")


# The forwards (K3, K8a): sweep warps (up to FWD_SWEEP_WARPS) hold K
# contiguous states a lane, ``loader_warps`` warps gather each frame's
# emissions into a ring of ``depth`` slots of ``frames`` frames (one row of
# K x 32 x sweep_warps floats a frame); ``smem`` is byte for byte
# ``hl::lat::fwd_layout``. K8a takes K = 4 over a warpgroup at the train
# shapes (S = 387): 2 over 7 warps, K4's stencil, read 0.171 ms against
# 0.151–0.153 in one-call timings on the H100 (PERF.md); K3 K = 2 over a
# warpgroup at S' = 193 (``ctc_cuda.FWD_MIN_PER_LANE``).
FWD_SWEEP_WARPS = 8
LOADER_WARPS = 2
FWD_K = (2, 4, 8)       # the forward kernels' instantiations of K


def fwd_max_warps(K):
    """The forward's launch bound (hl::lat::fwd_max_threads): 12 warps at
    2 and 4 states a lane, 18 at 8."""
    return 18 if K >= 8 else MAX_WARPS


class FwdPlan(NamedTuple):
    states: int         # S
    classes: int        # C (CTC) or 2V (Star-CTC)
    per_lane: int       # K: states a sweep lane owns
    sweep_warps: int
    loader_warps: int
    frames: int         # frames a ring slot
    depth: int          # ring slots
    smem: int           # bytes of dynamic shared memory
    threads: int        # 32 x (sweep_warps + loader_warps)

    @property
    def lanes(self):
        return 32 * self.sweep_warps

    @property
    def slot(self):
        return self.per_lane * self.lanes


FWD_EDGES = 32          # a warp's tagged edge words (hl::lat::FWD_EDGES)


def fwd_smem_bytes(S, K, sweep_warps, frames, depth):
    """hl::lat::fwd_layout(...).bytes: mbarriers, the warps' edge words,
    the last four states, each state's class, then the ring."""
    return (_align16(2 * depth * 8) + sweep_warps * FWD_EDGES * 8 + 16 +
            _align16(S * 4) + depth * frames * K * 32 * sweep_warps * 4)


def sweep_cap(K):
    """The most sweep warps a forward plan with K states a lane takes:
    FWD_SWEEP_WARPS, and 16 at 8 states a lane (at S = 4091, 16 warps of
    8 states read 8.48 ms, 8 warps of 16 states 10.94, on the H100;
    PERF.md)."""
    return 16 if K == 8 else FWD_SWEEP_WARPS


@functools.lru_cache(maxsize=256)
def forward_plan(S, C, min_per_lane, name):
    """The launch of a forward lattice of ``S`` states and ``C`` classes:
    the least K of ``FWD_K`` (at least ``min_per_lane``: 2 for K3, whose
    state types alternate, 4 for K8a's period of 4) with which
    ``sweep_cap(K)`` warps hold the states, only the warps that own
    states, ``LOADER_WARPS`` loader warps, and the first ring of
    ``RINGS`` that fits in ``SMEM_LIMIT``. Raises ValueError where no
    such plan exists; ``name`` is the caller's, for the message."""
    if S < 1 or C < 1:
        raise ValueError(f"{name}: {S} states, {C} classes")
    cap = min(MAX_STATES, 32 * sweep_cap(FWD_K[-1]) * FWD_K[-1])
    if S > cap:
        raise ValueError(f"{name}: {S} lattice states exceed the kernel's "
                         f"{cap}")
    K = next(k for k in FWD_K
             if k >= min_per_lane and 32 * sweep_cap(k) * k >= S)
    warps = -(-(-(-S // K)) // 32)
    if warps + LOADER_WARPS > fwd_max_warps(K):
        raise ValueError(f"{name}: {warps} + {LOADER_WARPS} warps exceed "
                         f"{fwd_max_warps(K)}")
    for frames, depth in RINGS:
        smem = fwd_smem_bytes(S, K, warps, frames, depth)
        if smem <= SMEM_LIMIT:
            return FwdPlan(S, C, K, warps, LOADER_WARPS, frames, depth,
                           smem, 32 * (warps + LOADER_WARPS))
    raise ValueError(f"{name}: {S} states do not fit in shared memory "
                     f"({SMEM_LIMIT} bytes)")
