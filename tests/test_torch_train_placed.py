"""The sharded train step on the rank's parameter blocks: each layer
gathered over the batch axes only while it runs, each leaf keeping the
rank's ``model`` block (``models.placed.GatherLeaf``), its gradient
summed onto the rank's blocks when its backward ends
(``placed.sum_block``), on 2x4, 1x8 and 2x2 gloo CPU ranks.

One world of 8 ranks (``dist.train_cases.placed_step_battery``; the 2x2
mesh leaves ranks 4-7 idle) runs:

* the gather's backward on every gather the six families' reduced models
  make (layer 0 of each stacked leaf, each unstacked leaf, the
  embedding table over its embed axes, the output projection), each
  rank's cotangent drawn from its rank: equal bit for bit to
  ``sum_block`` of the rank's cotangent, and within 1e-5 x max of the
  rank's block of every rank's cotangent summed in the test (eight fp32
  terms in another order); two planted faults (no sum over the axes that
  replicate a block; a sum over the vocab axes a partial gather keeps
  split) must miss that by far;
* ``trainer.sharded_value_and_grad`` on the blocks against a whole-gather
  gradient computed in the test (every leaf gathered before the forward,
  each whole partial summed onto the block): within 1e-6 x max|g| of each
  leaf, fp32, six families on 2x4 and 1x8; a planted fault (the
  embedding's vocab sum by the plain all_reduce, which autograd does not
  see) must fail it;
* with remat on at depth 4, the most gathered bytes alive at once
  (``placed.GATHERED``) at most two layers' worth plus the unstacked
  leaves', as the rank gathers them (``placed.held_bytes``: its
  ``model`` blocks, whole over the batch axes); the planted fault that gathers a block's weights before
  its checkpoint, so the checkpoint keeps them to the backward, must
  exceed it.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.dist import spawn  # noqa: E402
from repro_torch.dist import train_cases as tc  # noqa: E402

FAMILIES = [f for f, _ in tc.FAMILY_ARCHS]
SPEC = {"grads": ["2x4", "1x8"], "remat": ["2x4", "2x2"]}
#: the gather's block gradient against the cotangents summed here
SUM_TOL = 1e-5
#: the step on blocks against the whole-gather gradient (fp32)
GRAD_TOL = 1e-6


@pytest.fixture(scope="module")
def world():
    return spawn.run_ranks(tc.placed_step_battery, 8, device="cpu",
                           args=(SPEC,), timeout=300)


def _records(world, key):
    recs = [r[key] for r in world if key in r]
    assert recs, key
    return recs


@pytest.mark.parametrize("mesh", ["2x4", "1x8", "2x2"])
def test_gather_backward_is_the_block_of_every_ranks_cotangent(world, mesh):
    recs = _records(world, f"gather/{mesh}")
    assert len(recs) == (4 if mesh == "2x2" else 8)
    for rec in recs:
        assert rec["sum_block"] == 0.0
        assert rec["sum"] <= SUM_TOL


@pytest.mark.parametrize("fault", ["no_replica_sum", "keep_ignored"])
def test_planted_sum_faults_fail_the_gather_check(world, fault):
    recs = _records(world, f"gather/2x4/{fault}")
    assert max(r["sum"] for r in recs) > 100 * SUM_TOL


@pytest.mark.parametrize("mesh", SPEC["grads"])
@pytest.mark.parametrize("family", FAMILIES)
def test_step_on_blocks_matches_the_whole_gather_gradient(world, family,
                                                          mesh):
    for errs in _records(world, f"grads/{mesh}/{family}"):
        path = max(errs, key=errs.get)
        assert errs[path] <= GRAD_TOL, (path, errs[path])


def test_planted_plain_embedding_sum_fails_the_gradient_check(world):
    recs = _records(world, "grads/2x4/planted")
    assert max(max(e.values()) for e in recs) > 100 * GRAD_TOL
    assert max(r["embed"] for r in recs) > 100 * GRAD_TOL


def _bound(rec):
    return 2 * rec["layer"] + rec["unstacked"]


@pytest.mark.parametrize("mesh", SPEC["remat"])
@pytest.mark.parametrize("family", FAMILIES)
def test_remat_holds_at_most_two_gathered_layers(world, family, mesh):
    for rec in _records(world, f"remat/{mesh}/{family}/False"):
        assert 0 < rec["peak"] <= _bound(rec), rec


@pytest.mark.parametrize("mesh", SPEC["remat"])
@pytest.mark.parametrize("family", FAMILIES)
def test_planted_gather_outside_the_checkpoint_fails_the_remat_check(
        world, family, mesh):
    for rec in _records(world, f"remat/{mesh}/{family}/True"):
        assert rec["peak"] > _bound(rec), rec
