"""The port's fault zoo and chaos harness on the CPU, alone and beside the
JAX package's.

First the cases of tests/test_faultmodel.py on ``repro_torch.core``:
seeded campaigns, preset invariants under every recovery mode, the
partition split-brain guard and the vectorized scope scans. Every cluster
the harness builds runs the torch data plane on the host
(``ChaosHarness(..., device="cpu")``).

Then ``ChaosHarness(seed=0).run_matrix(64)`` on both packages, the
reference under the stand-in ``repro.dist.dataplane`` of
test_torch_runtime.py: each of the 50 reports' ``to_dict()`` must be equal,
and every campaign byte-identical.
"""
import functools
import random
import sys

import pytest
from hypothesis import given, strategies as st

pytest.importorskip("torch")

from test_torch_runtime import _stand_in_module, norm  # noqa: E402

import repro.core as R  # noqa: E402
from repro_torch.core.chaos import RECOVERIES, ChaosHarness  # noqa: E402
from repro_torch.core.faultmodel import FaultCampaign, FaultModel  # noqa: E402
from repro_torch.core.hierarchy import LegionTopology  # noqa: E402
from repro_torch.core.types import ChaosAction  # noqa: E402

# the port's default data plane is torch on "cuda": here it runs on the host
Harness = functools.partial(ChaosHarness, device="cpu")

N = 64          # auto-policy builds depth 3 / k=4 — racks and subtrees exist


# -- campaign generation ----------------------------------------------------

@given(seed=st.integers(0, 2**32 - 1),
       scenario=st.sampled_from(FaultModel.SCENARIOS))
def test_campaigns_reproducible(seed, scenario):
    """Same (seed, scenario, n) -> byte-identical campaign."""
    a = FaultModel(seed=seed).campaign(scenario, N)
    b = FaultModel(seed=seed).campaign(scenario, N)
    assert a.events == b.events
    assert a.meta == b.meta


def test_campaigns_reproducible_deterministic():
    for scenario in FaultModel.SCENARIOS:
        for seed in (0, 7, 13):
            a = FaultModel(seed=seed).campaign(scenario, N)
            b = FaultModel(seed=seed).campaign(scenario, N)
            assert a.events == b.events and a.meta == b.meta
    # seeds actually steer the generator
    assert (FaultModel(seed=0).campaign("independent", N).events
            != FaultModel(seed=1).campaign("independent", N).events)


def test_campaign_shape():
    c = FaultModel(seed=0).campaign("cascade", N)
    assert isinstance(c, FaultCampaign)
    assert list(c.events) == sorted(c.events, key=lambda e: e.step)
    assert all(0 <= n < N for e in c.events for n in e.nodes)
    assert c.horizon >= max(e.step for e in c.events)
    # the injector carries exactly the CRASH events
    inj = c.injector()
    assert {n for e in c.events if e.action is ChaosAction.CRASH
            for n in e.nodes} == {f.node for f in inj.events}


def test_unknown_scenario_rejected():
    with pytest.raises(ValueError):
        FaultModel().campaign("meteor_strike", N)


def test_rack_outage_targets_interior_legions():
    c = FaultModel(seed=3).campaign("rack_outage", N, racks=2)
    topo = LegionTopology.build(list(range(N)), 4, depth=3)
    subtrees = {r["subtree"] for r in c.meta["racks"]}
    assert len(subtrees) == 2                   # distinct top-level subtrees
    for r in c.meta["racks"]:
        lg = topo.legions[r["legion"]]
        assert sorted(lg.members) == sorted(r["members"])
        assert topo.subtree_of(lg.index) == r["subtree"]


# -- preset invariants across the recovery modes ----------------------------

@pytest.mark.parametrize("scenario", FaultModel.SCENARIOS)
@pytest.mark.parametrize("recovery", RECOVERIES)
def test_train_presets_pass_invariants(scenario, recovery):
    report = Harness(seed=0).run_train(scenario, N, recovery=recovery)
    assert report.passed, report.failures


@pytest.mark.parametrize("scenario", FaultModel.SCENARIOS)
def test_serve_presets_pass_invariants(scenario):
    report = Harness(seed=0).run_serve(scenario, N)
    assert report.passed, report.failures


# -- the partition split-brain guard ----------------------------------------

@pytest.mark.parametrize("fence", [True, False])
def test_partition_never_double_repairs(fence):
    """Fenced or not, each node lands in at most one terminal verdict and
    the majority side is never condemned (unfenced relies on the agree
    stage's majority quorum — a plain union would repair both sides)."""
    h = Harness(seed=3)
    campaign = h.model.campaign("network_partition", N, fence=fence)
    report = h.run_train("network_partition", N, fence=fence)
    assert report.passed, report.failures
    minority = set(campaign.meta["minority"])
    majority = set(campaign.meta["majority"])
    repaired = set(report.counts["repaired"])
    assert repaired == minority
    assert not (repaired & majority)


# -- vectorized scope scans vs the retired reference ------------------------

def _assert_scopes_identical(topo, faults):
    for node in faults:
        assert topo.fault_groups(node) == topo._fault_groups_reference(node)
    assert topo.partition_scopes(set(faults)) == \
        topo._partition_scopes_reference(set(faults))


@given(n=st.integers(3, 150), k=st.integers(2, 10),
       depth=st.integers(1, 4), data=st.data())
def test_vectorized_scopes_match_reference(n, k, depth, data):
    topo = LegionTopology.build(list(range(n)), k, depth=depth)
    count = data.draw(st.integers(1, max(1, n // 3)))
    faults = data.draw(st.permutations(list(topo.nodes)))[:count]
    _assert_scopes_identical(topo, faults)


def test_vectorized_scopes_match_reference_deterministic():
    rnd = random.Random(6)
    for _ in range(25):
        n = rnd.randrange(3, 150)
        k = rnd.randrange(2, 10)
        depth = rnd.randrange(1, 5)
        topo = LegionTopology.build(list(range(n)), k, depth=depth)
        faults = rnd.sample(list(topo.nodes),
                            rnd.randrange(1, max(2, n // 3)))
        _assert_scopes_identical(topo, faults)


# -- side by side with the reference ----------------------------------------

@pytest.fixture
def reference(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro.dist.dataplane", _stand_in_module())


def test_run_matrix_matches_reference(reference):
    """Every (scenario x recovery x workload) report of the 64-node matrix:
    the same checks, verdicts and counts as the reference's."""
    want = [r.to_dict() for r in R.ChaosHarness(seed=0).run_matrix(N)]
    got = [r.to_dict() for r in Harness(seed=0).run_matrix(N)]
    assert len(got) == len(want) == 50
    for g, w in zip(got, want):
        assert g == w, (w["scenario"], w["workload"], w["recovery"])
    assert all(w["passed"] for w in want)


@pytest.mark.parametrize("scenario", FaultModel.SCENARIOS)
def test_campaigns_match_reference(scenario):
    for seed in (0, 3):
        for n in (16, N):
            try:
                want = R.FaultModel(seed=seed).campaign(scenario, n)
            except ValueError as exc:
                with pytest.raises(ValueError, match=str(exc)[:30]):
                    FaultModel(seed=seed).campaign(scenario, n)
                continue
            got = FaultModel(seed=seed).campaign(scenario, n)
            assert norm(got) == norm(want)
            assert got.summary() == want.summary()
            assert norm(got.injector().events) == norm(want.injector().events)


def test_harness_needs_a_card_unless_told_cpu(monkeypatch):
    """The harness's clusters run the torch plane on "cuda" by default:
    without a card that raises; nothing falls back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ChaosHarness(seed=0).run_train("independent", 16)
    assert Harness(seed=0).run_train("independent", 16).passed
