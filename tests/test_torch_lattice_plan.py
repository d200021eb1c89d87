"""The launch plans of the lattice kernels on ``csrc/lattice.cuh``'s
skeleton (``haloop_tpu_torch/ops/lattice_cuda.py``): the backwards K4
and K8b (through ``ops/ctc_cuda.plan`` and ``ops/star_cuda.plan``) and
the forwards K3 and K8a (``ops/ctc_cuda.fwd_plan``,
``ops/star_cuda.fwd_plan``), on the CPU: every state
owned by exactly one sweep lane, every stencil neighbour found where the
kernels read it (a register of the lane, a neighbouring lane's by
shuffle, a warp's edge through shared memory, the start lane before the
lattice or the pad past it), the rings and class lists within the
block's shared memory, the same plan on every call, and ValueError just
past the limits. Pure Python: no card.
"""

import pytest

from haloop_tpu_torch.ops import ctc_cuda, lattice_cuda, star_cuda

STATES = (3, 31, 32, 33, 127, 128, 129, 193, 387, 1025, 2047, 4095)
CLASSES = (5, 512, 1024)
STAR_MAX = 4096 - 4 - 1            # K8a's lanes: PAD + S + 1 <= 4096
# the stencils' reach: CTC reads s+1, s+2 (the next lane's first two
# registers); Star-CTC s+1 .. s+4 (the next lane's first four) and s-1
# from the lane's own run (at a lane's first state the kernel leaves the
# masked back edge out)
REACH = {"ctc": ((1, 2), 2), "star": ((-1, 1, 2, 3, 4), 4)}


def _plan(kind):
    return ctc_cuda.plan if kind == "ctc" else star_cuda.plan


def _source(p, s, d, exchanged):
    """Where the kernel's lane owning state s reads its neighbour s + d:
    ("own" | "shuffle" | "edge", lane, register) or ("pad",)."""
    K, lane = p.per_lane, s // p.per_lane
    j = s % K + d
    if 0 <= j < K:
        return ("own", lane, j)
    assert j >= K, "the kernel reads no state of the previous lane"
    other, reg = lane + 1, j - K
    assert reg < exchanged, "the kernel exchanges no such register"
    if other >= p.lanes:
        return ("pad",)
    same_warp = other // 32 == lane // 32
    return ("shuffle" if same_warp else "edge", other, reg)


@pytest.mark.parametrize("kind", ["ctc", "star"])
@pytest.mark.parametrize("C", CLASSES)
@pytest.mark.parametrize("S", STATES)
def test_plan_owns_every_state_once_and_fits(kind, S, C):
    if kind == "star" and S > STAR_MAX:
        with pytest.raises(ValueError, match="lattice states"):
            _plan(kind)(S, C)
        return
    p = _plan(kind)(S, C)
    K = p.per_lane
    assert K in lattice_cuda.PER_LANE and K >= (2 if kind == "ctc" else 4)
    # every state owned by one (lane, register), at one ring address
    owners = [lattice_cuda.owner(p, s) for s in range(S)]
    assert len(set(owners)) == S
    assert all(0 <= lane < p.lanes and 0 <= j < K for lane, j in owners)
    addrs = [lattice_cuda.address(p, s) for s in range(S)]
    assert len(set(addrs)) == S and max(addrs) < p.slot
    # only warps that own states sweep
    assert 32 * (p.sweep_warps - 1) < -(-S // K) <= p.lanes
    assert 1 <= p.sweep_warps <= lattice_cuda.SWEEP_WARPS
    # each neighbour is the state the stencil names, or a pad past it
    offsets, exchanged = REACH[kind]
    for s in range(S):
        for d in offsets:
            if d < 0 and s % K == 0:
                # a blank: the back edge s-1 -> s is open into stars only
                assert s % 4 == 0
                continue
            src = _source(p, s, d, exchanged)
            if src == ("pad",):
                assert not 0 <= s + d < S
            else:
                assert src[1] * K + src[2] == s + d
    # the rings and lists in shared memory, the block's threads
    assert p.smem == lattice_cuda.smem_bytes(S, C, K, p.sweep_warps,
                                             p.frames, p.depth, p.dense)
    assert p.smem <= lattice_cuda.SMEM_LIMIT
    assert (p.frames, p.depth) in lattice_cuda.RINGS
    assert p.threads == 32 * (p.sweep_warps + p.scatter_warps) <= \
        32 * lattice_cuda.max_warps(K)
    # the same plan on every call, cached or not
    assert _plan(kind)(S, C) is p
    lattice_cuda.plan.cache_clear()
    assert _plan(kind)(S, C) == p


def test_plans_at_the_train_shapes():
    """lstm:512's lattices: K4 at S' = 193 and K8b at S = 387 over a
    warpgroup (2 and 4 states a lane), 8 and 4 scatter warps, a ring of 4
    slots of 4 frames, the rows staged."""
    p = ctc_cuda.plan(193, 512)
    assert (p.per_lane, p.sweep_warps, p.scatter_warps, p.frames,
            p.depth, p.dense) == (2, 4, 8, 4, 4, True)
    p = star_cuda.plan(387, 1024)
    assert (p.per_lane, p.sweep_warps, p.scatter_warps, p.frames,
            p.depth, p.dense) == (4, 4, 4, 4, 4, True)


@pytest.mark.parametrize("C", CLASSES)
def test_plans_raise_just_past_the_limits(C):
    assert ctc_cuda.plan(4095, C).states == 4095           # U = 2047
    with pytest.raises(ValueError, match="4097 lattice states"):
        ctc_cuda.plan(4097, C)                             # U = 2048
    assert star_cuda.plan(4091, C).states == 4091          # U = 1022
    with pytest.raises(ValueError, match="4095 lattice states"):
        star_cuda.plan(4095, C)                            # U = 1023


def test_plans_stage_the_rows_while_they_fit_and_raise_past_the_lists():
    """A slot's rows staged in shared memory while they fit; wider class
    rows written straight to the gradient (the class starts, C + 1 ints,
    beside the smallest ring, 2 slots of a frame); the largest C that
    fits so at S' = 193 plans, one more raises: the parent kernel's range
    (4 C bytes and its lists)."""
    def fits(C, dense):
        return lattice_cuda.smem_bytes(193, C, 2, 4, 1, 2, dense) <= \
            lattice_cuda.SMEM_LIMIT
    staged = max(C for C in range(1000, 60000, 16) if fits(C, True))
    assert ctc_cuda.plan(193, staged).dense
    assert not ctc_cuda.plan(193, staged + 16).dense
    direct = max(C for C in range(staged, 60000, 16) if fits(C, False))
    assert direct > 50000
    p = ctc_cuda.plan(193, direct)
    assert (p.frames, p.depth, p.dense) == (1, 2, False)
    with pytest.raises(ValueError, match="does not fit in shared memory"):
        ctc_cuda.plan(193, direct + 16)


# ------------------------------------------- the forward K8a (forward_plan)

def _fwd_source(p, s, d):
    """Where K8a's lane owning state s reads its neighbour s + d, as
    csrc/star_fwd.cu does: ("own" | "shuffle" | "edge", lane, register),
    or ("start",) for state -1 (the start lane). A lane reads the
    previous lane's last register only."""
    K, lane = p.per_lane, s // p.per_lane
    j = s % K + d
    if 0 <= j < K:
        return ("own", lane, j)
    t = s + d
    if t < 0:
        return ("start",)
    other, reg = divmod(t, K)
    assert other == lane - 1 and reg == K - 1, "only the last register"
    same_warp = other // 32 == lane // 32
    return ("shuffle" if same_warp else "edge", other, reg)


def _fwd_offsets(s):
    """The stencil's reach into state s (a blank s-1; a star s-1, s+1; a
    label s-1 .. s-4)."""
    return {0: (-1,), 1: (-1, 1), 2: (-1,), 3: (-3, -2, -1, -4)}[s % 4]


@pytest.mark.parametrize("C", CLASSES)
@pytest.mark.parametrize("S", STATES)
def test_forward_plan_owns_every_state_once_and_fits(S, C):
    if S > STAR_MAX:
        with pytest.raises(ValueError, match="lattice states"):
            star_cuda.fwd_plan(S, C)
        return
    p = star_cuda.fwd_plan(S, C)
    K = p.per_lane
    assert K in lattice_cuda.FWD_K and K % 4 == 0
    owners = [divmod(s, K) for s in range(S)]
    assert len(set(owners)) == S
    assert all(0 <= lane < p.lanes for lane, _ in owners)
    assert 32 * (p.sweep_warps - 1) < -(-S // K) <= p.lanes
    assert p.sweep_warps <= lattice_cuda.sweep_cap(K)
    for s in range(S):
        for d in _fwd_offsets(s):
            src = _fwd_source(p, s, d)
            if src == ("start",):
                assert s + d == -1
            else:
                assert src[1] * K + src[2] == s + d
    assert p.smem == lattice_cuda.fwd_smem_bytes(
        S, K, p.sweep_warps, p.frames, p.depth) <= lattice_cuda.SMEM_LIMIT
    assert (p.frames, p.depth) in lattice_cuda.RINGS
    assert p.threads == 32 * (p.sweep_warps + p.loader_warps) <= \
        32 * lattice_cuda.fwd_max_warps(K)
    assert star_cuda.fwd_plan(S, C) is p


def test_forward_plans_at_the_train_shape():
    """lstm:512 --star-penalty's lattice (S = 387): 4 states a lane over a
    warpgroup, 2 loader warps and a ring of 4 slots of 4 frames; up to
    1,024 states 4 a lane, then 8."""
    p = star_cuda.fwd_plan(387, 1024)
    assert (p.per_lane, p.sweep_warps, p.loader_warps, p.frames,
            p.depth) == (4, 4, 2, 4, 4)
    assert star_cuda.fwd_plan(1023, 1024).per_lane == 4
    assert star_cuda.fwd_plan(1027, 1024).per_lane == 8


def test_forward_plans_take_r3s_range_and_raise_past_it():
    """S = 1027 and 4091 (U = 1022, the longest the Star-CTC kernels
    take) plan with 8 states a lane over up to 16 sweep warps, the latter
    with the smaller ring; U = 1023 raises."""
    p = star_cuda.fwd_plan(1027, 1024)
    assert (p.per_lane, p.sweep_warps) == (8, 5)
    p = star_cuda.fwd_plan(4091, 1024)
    assert (p.per_lane, p.sweep_warps, p.frames, p.depth) == (8, 16, 4, 2)
    assert p.threads == 32 * 18
    with pytest.raises(ValueError, match="4095 lattice states"):
        star_cuda.fwd_plan(4095, 1024)


# ------------------------------------------- the forward K3 (forward_plan)

def _ctc_fwd_offsets(s):
    """The CTC stencil's reach into state s: a blank s-1, a label s-1 and
    s-2 (the skip)."""
    return (-1,) if s % 2 == 0 else (-1, -2)


@pytest.mark.parametrize("C", CLASSES)
@pytest.mark.parametrize("S", [s for s in STATES if s % 2] + [2049])
def test_ctc_forward_plan_owns_every_state_once_and_fits(S, C):
    """K3's plans: K even (a register's index fixes its state's type),
    every state owned once, each stencil neighbour in the lane's own
    registers or the previous lane's last (a shuffle, or across a warp's
    edge through shared memory), the shared memory fwd_layout's."""
    p = ctc_cuda.fwd_plan(S, C)
    K = p.per_lane
    assert K in lattice_cuda.FWD_K and K % 2 == 0
    assert K >= ctc_cuda.FWD_MIN_PER_LANE
    owners = [divmod(s, K) for s in range(S)]
    assert len(set(owners)) == S
    assert all(0 <= lane < p.lanes and j % 2 == s % 2
               for s, (lane, j) in zip(range(S), owners))
    assert 32 * (p.sweep_warps - 1) < -(-S // K) <= p.lanes
    assert p.sweep_warps <= lattice_cuda.sweep_cap(K)
    for s in range(S):
        for d in _ctc_fwd_offsets(s):
            src = _fwd_source(p, s, d)
            if src == ("start",):
                assert s + d == -1
            elif s + d < -1:
                pytest.fail("the kernel reads no state before the start")
            else:
                assert src[1] * K + src[2] == s + d
    assert p.smem == lattice_cuda.fwd_smem_bytes(
        S, K, p.sweep_warps, p.frames, p.depth) <= lattice_cuda.SMEM_LIMIT
    assert (p.frames, p.depth) in lattice_cuda.RINGS
    assert p.threads == 32 * (p.sweep_warps + p.loader_warps) <= \
        32 * lattice_cuda.fwd_max_warps(K)
    assert ctc_cuda.fwd_plan(S, C) is p


def test_ctc_forward_plans_at_the_train_shape(monkeypatch):
    """lstm:512's lattice (S' = 193, 512 classes): 2 states a lane over a
    warpgroup, 2 loader warps, a ring of 4 slots of 4 frames, the shared
    memory fwd_layout's; with 4 states a lane forced (the variant K3's
    choice was timed against), 2 sweep warps."""
    p = ctc_cuda.fwd_plan(193, 512)
    assert (p.per_lane, p.sweep_warps, p.loader_warps, p.frames,
            p.depth) == (2, 4, 2, 4, 4)
    assert p.smem == lattice_cuda.fwd_smem_bytes(193, 2, 4, 4, 4)
    monkeypatch.setattr(ctc_cuda, "FWD_MIN_PER_LANE", 4)
    p = ctc_cuda.fwd_plan(193, 512)
    assert (p.per_lane, p.sweep_warps, p.loader_warps) == (4, 2, 2)


def test_ctc_forward_plans_take_r3s_range_and_raise_past_it():
    """S' = 2049 and 4095 (U = 2047, the longest K3 takes) plan with 8
    states a lane over 9 and 16 sweep warps, the latter with the smaller
    ring; 4097 raises, as K4's plan does."""
    p = ctc_cuda.fwd_plan(2049, 40)
    assert (p.per_lane, p.sweep_warps) == (8, 9)
    p = ctc_cuda.fwd_plan(4095, 40)
    assert (p.per_lane, p.sweep_warps, p.frames, p.depth) == (8, 16, 4, 2)
    assert p.threads == 32 * 18
    with pytest.raises(ValueError, match="4097 lattice states"):
        ctc_cuda.fwd_plan(4097, 40)
