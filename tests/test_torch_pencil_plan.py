"""The pencil planner of xrft_tpu_torch against xrft_tpu's, on the host
(no processes): ``plan_forward_layout`` is copied, not imported, and must
give the same steps and final layout on the fuzz generator of
``tests/test_parallel.py:839-868``, on the DCN-hinted cases of
``tests/test_parallel.py:568-617``, and on further random cases with a
banned (real) axis and topology hints.
"""

import numpy as np
import pytest

from xrft_tpu.parallel import pencil as ref_pencil
from xrft_tpu_torch.parallel import pencil as port_pencil
from test_parallel import PENCIL_FUZZ

MESH_AXES = {
    "p8": [("p", 8)], "p24": [("p1", 2), ("p2", 4)],
    "p42": [("p1", 4), ("p2", 2)], "p222": [("a", 2), ("b", 2), ("c", 2)],
    "p23": [("q1", 2), ("q2", 3)],
}


def _fuzz_plan_args(case):
    """The planner's arguments of one test_pencil_planner_fuzz case, drawn
    as that test draws them (tests/test_parallel.py:868-892)."""
    rs = np.random.RandomState(case["seed"])
    axes_sizes = MESH_AXES[case["tag"]]
    ndim, kind = case["ndim"], case["kind"]
    lcm = int(np.lcm.reduce([s for _, s in axes_sizes]))
    shape = tuple(int(lcm * rs.choice([1, 2, 3])) for _ in range(ndim))
    n_t = int(rs.randint(1, ndim + 1))
    tdims = sorted(rs.choice(ndim, size=n_t, replace=False).tolist())
    if kind == "rfft":
        tdims = sorted(set(tdims) | {ndim - 1})
    shardable = [a for a in range(ndim)
                 if not (kind == "rfft" and a == ndim - 1)]
    rs.shuffle(shardable)
    sharding = {}
    for (name, _), a in zip(axes_sizes, shardable):
        if rs.rand() < 0.8:
            sharding[a] = name
    chain = tdims[:-1] if kind == "rfft" else tdims
    banned = (ndim - 1,) if kind == "rfft" else ()
    return shape, chain, sharding, dict(axes_sizes), banned


def _same_plan(*args, **kw):
    want = ref_pencil.plan_forward_layout(*args, **kw)
    got = port_pencil.plan_forward_layout(*args, **kw)
    assert got == want
    return got


@pytest.mark.parametrize("case", PENCIL_FUZZ,
                         ids=lambda c: f"pf{c['seed']}_{c['tag']}")
def test_planner_matches_reference_on_fuzz(case):
    _same_plan(*_fuzz_plan_args(case))


def test_plan_dcn_axes_ordered_last():
    """tests/test_parallel.py:568-582."""
    links = {"d": "dcn", "i": "ici"}
    steps, final = _same_plan((8, 8, 8), [1, 2], {1: "d", 2: "i"},
                              {"d": 2, "i": 4}, axis_links=links)
    assert [s[1] for s in steps] == [2, 1]
    assert final[steps[1][2]] == "d"


@pytest.mark.parametrize("shape,links,want", [
    ((3, 12, 9, 8), {"d": "dcn", "i": "ici"},
     [("move", 2, 0, "i"), ("move", 3, 1, "d")]),
    ((12, 3, 9, 8), {"d": "dcn", "i": "ici"},
     [("move", 2, 1, "i"), ("move", 3, 0, "d")]),
    ((12, 3, 9, 8), None, [("move", 2, 0, "i")]),
])
def test_plan_ici_move_reserves_dcn_destination(shape, links, want):
    """tests/test_parallel.py:585-616."""
    steps, _ = _same_plan(shape, [2, 3], {2: "i", 3: "d"},
                          {"i": 3, "d": 2}, axis_links=links)
    for s in want:
        assert s in steps


def test_forward_chain_output_layout_planned():
    """tests/test_parallel.py:177-186."""
    steps, final = _same_plan((8, 16, 32), [1, 2], {1: "p1", 2: "p2"},
                              {"p1": 2, "p2": 4})
    assert [s[0] for s in steps] == ["move", "move"]
    assert final == {0: "p1", 1: "p2"}


def _random_case(seed):
    rs = np.random.RandomState(seed)
    ndim = int(rs.randint(1, 5))
    names = ["m0", "m1", "m2"][:int(rs.randint(1, 4))]
    sizes = {m: int(rs.choice([1, 2, 3, 4])) for m in names}
    shape = tuple(int(rs.choice([1, 2, 3, 4, 6, 8, 12, 16]))
                  for _ in range(ndim))
    chain = sorted(rs.choice(ndim, size=int(rs.randint(0, ndim + 1)),
                             replace=False).tolist())
    rs.shuffle(chain)
    axes = list(rs.permutation(ndim))
    sharding = {int(a): m for a, m in zip(axes, names) if rs.rand() < 0.7}
    banned = (ndim - 1,) if rs.rand() < 0.4 and ndim - 1 not in sharding \
        else ()
    chain = [a for a in chain if a not in banned]
    links = {m: rs.choice(["ici", "dcn"]) for m in names} \
        if rs.rand() < 0.5 else None
    return shape, chain, sharding, sizes, banned, links


@pytest.mark.parametrize("seed", range(48))
def test_planner_matches_reference_random(seed):
    shape, chain, sharding, sizes, banned, links = _random_case(seed)
    _same_plan(shape, chain, sharding, sizes, banned, axis_links=links)


@pytest.mark.parametrize("n,shards,axis", [
    (7, {0: "p"}, 0), (6, {1: "p"}, 0), (5, {0: "p"}, 0)])
def test_rt_buddy_matches_reference(n, shards, axis):
    shape = (n, 4)
    assert port_pencil._rt_buddy(2, axis, shards, shape, 2) == \
        ref_pencil._rt_buddy(2, axis, shards, shape, 2)
