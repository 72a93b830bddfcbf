"""The port's keyframe DB sharded over DB slots (`parallel/dist_loop.py`)
against its local detector, bit for bit
(`tests/torch_dist_cases.py:loop_suite`): a kf=4 mesh of four gloo ranks
with the sharded query, fetch and add installed in the port's
`LoopDetector`, and beside it the local detector on one rank, fed the
same keyframes (three base images revisited, tests/test_dist_loop.py's
frames) and the same PnP noise: every result equal (found, slots,
scores, relative poses, match and inlier counts; the revisits'
candidates score over 0.5, though no random frame passes PnP), every
rank alike, and the DB gathered from the shards (`gather_db`) equal to
the local DB in every field on every rank.
"""

import pytest
import torch

import torch_dist_cases as cases

RANKS = 4
FRAMES = 12


@pytest.fixture(scope="module")
def ranks():
    return cases.run_groups({"mesh": (cases.loop_suite, RANKS, (FRAMES,)),
                             "local": (cases.loop_suite, 1, (FRAMES,))}, timeout_s=240)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def test_sharded_results_equal_local(ranks):
    local = ranks["local"][0]["results"]
    # the revisits find candidates (LoopResult.score, the picked one's)
    assert sum(r is not None and float(r[7]) > 0.5 for r in local) >= 3
    for rk in ranks["mesh"]:
        assert len(rk["results"]) == len(local)
        for a, b in zip(rk["results"], local):
            assert (a is None) == (b is None)
            if a is None:
                continue
            for x, y in zip(a, b):
                assert torch.equal(_bits(x), _bits(y))


def test_sharded_db_equals_local(ranks):
    local = ranks["local"][0]
    assert all(r["count"] == local["count"] == FRAMES for r in ranks["mesh"])
    for r in ranks["mesh"]:
        # the scores were psum'd, the rows fetched and written by their owner
        assert r["stats"]["kf"]["psum"][0] > 0 and r["stats"]["kf"]["all_gather"][0] > 0
        for got, want in zip(r["db"], local["db"]):
            assert torch.equal(_bits(got), _bits(want))
    assert int(local["db"][12].sum()) == FRAMES          # valid rows
